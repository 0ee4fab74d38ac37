// The register-blocked fp32 FMA GEMM body on CUDA cores shared by the
// chain's f32 stages (chain.cu) and the factored receiver's estimator GEMM
// (factored.cu); rx.cu's Gauss GEMM takes its cp.async copies. A CTA of
// 128 threads computes a 64 x 128 output tile, each thread an 8 x 8 block
// (rows ty + 8 i, columns 4 tx + 64 h + e). k runs in 16-deep tiles
// through a four-slot cp.async ring (48 KB); the caller's loader fills a
// slot (A [m][k], W [k][n]) and zero-fills what lies past its operands, so
// four k of a row and a k-row of eight columns are 16-byte shared loads
// (LDS.128): 16 shared loads per 256 FMA, the FMAs in a zigzag over the
// columns. Every output is one FMA chain over k in order, from zero, with
// no split-k. FMA on CUDA cores, no TF32.
#pragma once

#include <cuda_runtime.h>

namespace gfdm {
namespace fg {

constexpr int BM = 64, BN = 128, BK = 16, STAGES = 4, THREADS = 128;
constexpr int TM = 8, TN = 8;  // a thread's block: rows ty + 8 i, columns 4 tx + 64 h + e
constexpr int TY = THREADS / 16;
static_assert(BM == TY * TM && BN == 16 * TN, "fma tiling");
constexpr int SLOT = BM * BK + BK * BN;  // floats a ring slot: A [m][k], W [k][n]
constexpr size_t SMEM = sizeof(float) * STAGES * SLOT;

// 16 bytes, or zeros where !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, or a zero where !valid
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// acc = the sum over nt k-tiles of the thread's block of the products;
// load(slot, k0) starts the copies of the k-tile at k0 into `slot`. `smem`
// holds the ring (SMEM bytes, 16-byte aligned).
template <typename Load>
__device__ __forceinline__ void mainloop(float (&acc)[TM][TN], float* smem, int nt, Load load) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) load(smem + s * SLOT, s * BK);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t has landed
    __syncthreads();              // ... for every thread, and tile t - 1's slot is free
    const int tn = t + STAGES - 1;
    if (tn < nt) load(smem + (tn % STAGES) * SLOT, tn * BK);
    cp_async_commit();
    const float* as = smem + (t % STAGES) * SLOT;
    const float* ws = as + BM * BK;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      // a warp reads two rows (16 words apart: other banks), broadcast
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (ty + TY * i) * BK + k4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* wr = ws + (k4 + e) * BN + 4 * tx;
        const float4 b0 = *reinterpret_cast<const float4*>(wr);
        const float4 b1 = *reinterpret_cast<const float4*>(wr + 64);
        const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float ai = lane4(av[i], e);
          // odd rows walk the columns backwards, so the FMA after a row
          // change reuses the W operand of the one before (operand reuse)
#pragma unroll
          for (int jj = 0; jj < TN; ++jj) {
            const int j = (i & 1) ? TN - 1 - jj : jj;
            acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
          }
        }
      }
    }
  }
}

}  // namespace fg
}  // namespace gfdm
