// The link's GEMM chain for Hopper (sm_90a): out = x @ W1 @ W2 @ W3 at the
// one-kernel link's chain shapes, (B, 936) -> 1152 -> 1152 -> 1152, in three
// modes.
//
// Replaces the Pallas kernel of benchmarks/int8_gauss.py (build, :85, with
// the bodies _chain_f32, _chain_bf16 and _chain_int8):
//   f32  - float32 products and sums;
//   bf16 - the activation rounded to bf16 (nearest even) before each
//          product, bf16 weights, float32 sums, float32 output;
//   int8 - before each product the activation of each 128-row group is
//          quantized with that group's absmax m: s = 127 / max(m, 1e-20),
//          q = clip(rint(x s), -127, 127); int8 weights quantized on the
//          host with one float32 inverse scale `inv` each; int32 sums;
//          out = float(acc) * (c * max(m, 1e-20)), c = inv / 127 in float32:
//          XLA evaluates the script's inv / s so, folding inv / (127 / m')
//          into (inv / 127) * m' (kernels/chain.py, tests/test_torch_chain.py).
//
// Bound (H100 SXM): 2 B (936 * 1152 + 2 * 1152^2) operations, 4.9e11 at
// B = 65,536: 7.3 ms at the 67 TFLOP/s of fp32 FMA, 0.49 ms at the 989
// TFLOP/s of dense bf16, 0.25 ms at the 1,979 TOP/s of dense int8. The bytes
// (x and out once, the weights once: 0.17 ms) never bind.
//
// Design: simple and right first.
// f32: one kernel. A CTA of 512 threads owns 32 rows through all three
//   stages: their (32, 1152) activation stays in shared memory (147 KB),
//   and the weights (L2-resident) stream through it in 8-row k-tiles
//   (cp.async, double-buffered, 74 KB). Each thread keeps an 8 x 9 block of
//   the stage's output in registers; FMA on CUDA cores, no TF32. The chain
//   never leaves the chip, as in the TPU kernel.
// bf16: the same one-kernel structure; the activation is held as bf16 (it
//   is rounded to bf16 before each product anyway: 74 KB at 32 rows) and
//   the products run on tensor cores (wmma 16x16x16, bf16 -> float32),
//   each of the 16 warps owning nine 16x16 output tiles of a stage.
// int8: a group's (128, 1152) stage output (590 KB as float32) does not fit
//   a CTA, and the next stage's scale needs the whole group's max, so one
//   launch a stage plus one absmax pass over x: four launches. A CTA
//   computes a (128, 128) tile of one group: it quantizes the float32
//   activation tile it loads with the group's scale, multiplies on tensor
//   cores (wmma 16x16x16, s8 -> s32), and its epilogue writes
//   float(acc) * (c * m') and folds |value| into the next stage's group max
//   with atomicMax on the float's bits (non-negative floats order as their
//   bits, and a max is exact in any order). Division and rounding are IEEE
//   (no fast math, no contraction of x * s), so the result equals the plain
//   version's bit for bit. The int8 weights come transposed, (1152, k)
//   with k zero-padded to a multiple of 64, so a tile loads as 16-byte rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace gfdm {
namespace chain {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int HID = 1152;   // width of every stage's output
constexpr int GROUP = 128;  // rows sharing one int8 activation scale
constexpr int KPAD = 64;    // the int8 weights' k padding (kernels/chain.py _KPAD)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Max over a CTA of 256 threads; the result is valid in thread 0.
__device__ float block_max256(float m) {
  __shared__ float part[8];
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < 8 ? part[threadIdx.x] : 0.f;
    for (int o = 4; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  return m;
}

// ---------------------------------------------------------------------------
// f32: one kernel, the activation in shared memory through three stages
// ---------------------------------------------------------------------------
constexpr int F_BM = 32, F_BK = 8, F_THREADS = 512;
constexpr int F_RPT = 8, F_CPT = 9;  // a thread's output block: 8 rows x 9 columns
static_assert(F_BM == (F_THREADS / 128) * F_RPT && HID == 128 * F_CPT, "f32 tiling");
constexpr size_t F_SMEM = sizeof(float) * (F_BM * HID + 2 * F_BK * HID);

// Rows k0 .. k0 + F_BK of w (full 1152-wide rows: one contiguous run).
__device__ __forceinline__ void f32_load_tile(float* dst, const float* w, int k0, int tid) {
  const float* src = w + static_cast<size_t>(k0) * HID;
  for (int i = tid; i < F_BK * HID / 4; i += F_THREADS) cp_async16(dst + 4 * i, src + 4 * i);
  cp_async_commit();
}

__global__ void __launch_bounds__(F_THREADS, 1)
chain_f32_kernel(int d_in, const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ w2, const float* __restrict__ w3,
                 float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* act = reinterpret_cast<float*>(smem);  // [F_BM][HID]
  float* wt = act + F_BM * HID;                 // [2][F_BK][HID]
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * F_BM;
  for (int i = tid; i < F_BM * d_in / 4; i += F_THREADS) {
    const int r = 4 * i / d_in, k = 4 * i - r * d_in;
    *reinterpret_cast<float4*>(act + r * HID + k) =
        *reinterpret_cast<const float4*>(x + (row0 + r) * d_in + k);
  }
  // a warp shares its rows (broadcast reads of act) and reads 32 adjacent
  // columns of the tile (no bank conflict)
  const int r0 = (tid >> 7) * F_RPT, c0 = tid & 127;
  for (int s = 0; s < 3; ++s) {
    const float* w = s == 0 ? w1 : (s == 1 ? w2 : w3);
    const int nt = (s == 0 ? d_in : HID) / F_BK;
    float acc[F_RPT][F_CPT];
#pragma unroll
    for (int i = 0; i < F_RPT; ++i)
#pragma unroll
      for (int j = 0; j < F_CPT; ++j) acc[i][j] = 0.f;
    f32_load_tile(wt, w, 0, tid);
    for (int t = 0; t < nt; ++t) {
      if (t + 1 < nt) {
        f32_load_tile(wt + ((t + 1) & 1) * F_BK * HID, w, (t + 1) * F_BK, tid);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* wb = wt + (t & 1) * F_BK * HID;
#pragma unroll
      for (int kk = 0; kk < F_BK; ++kk) {
        const int k = t * F_BK + kk;
        float a[F_RPT], b[F_CPT];
#pragma unroll
        for (int i = 0; i < F_RPT; ++i) a[i] = act[(r0 + i) * HID + k];
#pragma unroll
        for (int j = 0; j < F_CPT; ++j) b[j] = wb[kk * HID + c0 + 128 * j];
#pragma unroll
        for (int i = 0; i < F_RPT; ++i)
#pragma unroll
          for (int j = 0; j < F_CPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    // every read of act is done (the barrier above); the next stage's first
    // barrier orders these writes before its reads
#pragma unroll
    for (int i = 0; i < F_RPT; ++i)
#pragma unroll
      for (int j = 0; j < F_CPT; ++j) {
        if (s < 2) {
          act[(r0 + i) * HID + c0 + 128 * j] = acc[i][j];
        } else {
          out[(row0 + r0 + i) * HID + c0 + 128 * j] = acc[i][j];
        }
      }
  }
}

// ---------------------------------------------------------------------------
// bf16: one kernel, bf16 activation in shared memory, wmma products
// ---------------------------------------------------------------------------
constexpr int H_BM = 32, H_BK = 32, H_THREADS = 512;
constexpr int H_LD = HID + 8;  // bf16 pitch: a multiple of 8 (wmma), rows 16 B apart mod 128
constexpr int H_TILES = HID / 16 / ((H_THREADS / 32) / (H_BM / 16));  // 9 a warp
static_assert(H_TILES == 9, "bf16 tiling");
constexpr size_t H_SMEM = sizeof(bf16) * (H_BM * H_LD + 2 * H_BK * H_LD);

// Rows k0 .. k0 + H_BK of w (kd x HID) into dst [H_BK][H_LD]; rows >= kd zero.
__device__ __forceinline__ void bf16_load_tile(bf16* dst, const bf16* w, int k0, int kd,
                                               int tid) {
  constexpr int CH = HID / 8;  // 16-byte chunks a row
  for (int i = tid; i < H_BK * CH; i += H_THREADS) {
    const int r = i / CH, c = i - r * CH;
    bf16* d = dst + r * H_LD + 8 * c;
    if (k0 + r < kd) {
      cp_async16(d, w + static_cast<size_t>(k0 + r) * HID + 8 * c);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(H_THREADS, 1)
chain_bf16_kernel(int d_in, const float* __restrict__ x, const bf16* __restrict__ w1,
                  const bf16* __restrict__ w2, const bf16* __restrict__ w3,
                  float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);  // [H_BM][H_LD]
  bf16* wt = act + H_BM * H_LD;               // [2][H_BK][H_LD]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * H_BM;
  // stage 0's activation rounded to bf16; columns [d_in, kp0) zero
  const int q0 = (d_in + H_BK - 1) / H_BK * H_BK / 4;
  for (int i = tid; i < H_BM * q0; i += H_THREADS) {
    const int r = i / q0, k = 4 * (i - r * q0);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < d_in) v = *reinterpret_cast<const float4*>(x + (row0 + r) * d_in + k);
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(act + r * H_LD + k);
    d[0] = __floats2bfloat162_rn(v.x, v.y);
    d[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  const int rt = warp & 1, ct0 = (warp >> 1) * H_TILES;  // row tile, first column tile
  for (int s = 0; s < 3; ++s) {
    const bf16* w = s == 0 ? w1 : (s == 1 ? w2 : w3);
    const int kd = s == 0 ? d_in : HID;
    const int nt = (kd + H_BK - 1) / H_BK;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[H_TILES];
#pragma unroll
    for (int j = 0; j < H_TILES; ++j) wmma::fill_fragment(acc[j], 0.f);
    bf16_load_tile(wt, w, 0, kd, tid);
    for (int t = 0; t < nt; ++t) {
      if (t + 1 < nt) {
        bf16_load_tile(wt + ((t + 1) & 1) * H_BK * H_LD, w, (t + 1) * H_BK, kd, tid);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* wb = wt + (t & 1) * H_BK * H_LD;
#pragma unroll
      for (int kk = 0; kk < H_BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, act + rt * 16 * H_LD + t * H_BK + kk, H_LD);
#pragma unroll
        for (int j = 0; j < H_TILES; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, wb + kk * H_LD + (ct0 + j) * 16, H_LD);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      __syncthreads();
    }
    if (s < 2) {
      // the fragments' layout is opaque: stage each through the (now free)
      // tile buffer as float32, then round it to bf16 into act
      float* stage = reinterpret_cast<float*>(wt) + warp * 256;
#pragma unroll
      for (int j = 0; j < H_TILES; ++j) {
        wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          act[(rt * 16 + (e >> 4)) * H_LD + (ct0 + j) * 16 + (e & 15)] =
              __float2bfloat16_rn(stage[e]);
        }
        __syncwarp();
      }
      __syncthreads();  // before the next stage's loads overwrite the staging
    } else {
#pragma unroll
      for (int j = 0; j < H_TILES; ++j) {
        wmma::store_matrix_sync(out + (row0 + rt * 16) * HID + (ct0 + j) * 16, acc[j], HID,
                                wmma::mem_row_major);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// int8: an absmax pass over x, then one launch a stage
// ---------------------------------------------------------------------------
constexpr int Q_BM = GROUP, Q_BN = 128, Q_BK = KPAD, Q_THREADS = 256;
constexpr int Q_SLABS = Q_BK / 16;  // 16-wide k slabs: 16-byte rows for wmma
constexpr int Q_LDS = Q_BN + 4;     // int32 pitch of the epilogue's staging
constexpr size_t Q_SMEM = static_cast<size_t>(Q_SLABS) * (Q_BM + Q_BN) * 16 +
                          sizeof(int) * Q_BM * Q_LDS;

// gmax[g] = bits of max |x| over the 128 rows of group g.
__global__ void __launch_bounds__(256)
chain_absmax_kernel(int d_in, const float* __restrict__ x, int* __restrict__ gmax) {
  const float4* p = reinterpret_cast<const float4*>(x + static_cast<size_t>(blockIdx.x) *
                                                           GROUP * d_in);
  float m = 0.f;
  for (int i = threadIdx.x; i < GROUP * d_in / 4; i += blockDim.x) {
    const float4 v = p[i];
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  m = block_max256(m);
  if (threadIdx.x == 0) gmax[blockIdx.x] = __float_as_int(m);
}

__device__ __forceinline__ signed char quantize(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, s)), -127.f), 127.f);
  return static_cast<signed char>(static_cast<int>(q));
}

// One stage of one group: a_out[g rows, n0 .. n0 + 128) = float(q(a_in) @ W)
// * (c * m'); gmax_out[g] (if given) takes the max |a_out| of the tile.
__global__ void __launch_bounds__(Q_THREADS)
chain_int8_stage_kernel(int kd, const float* __restrict__ a_in,
                        const signed char* __restrict__ w_t, float c,
                        const int* __restrict__ gmax_in, int* __restrict__ gmax_out,
                        float* __restrict__ a_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  signed char* aq = reinterpret_cast<signed char*>(smem);  // [slab][Q_BM][16]
  signed char* bq = aq + Q_SLABS * Q_BM * 16;              // [slab][Q_BN][16]: rows of W^T
  int* stg = reinterpret_cast<int*>(bq + Q_SLABS * Q_BN * 16);  // [Q_BM][Q_LDS]
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = blockIdx.y, n0 = blockIdx.x * Q_BN;
  const size_t row0 = static_cast<size_t>(g) * Q_BM;
  const int kp = (kd + Q_BK - 1) / Q_BK * Q_BK;  // the transposed weights' row length
  const float m = fmaxf(__int_as_float(gmax_in[g]), 1e-20f);
  const float s = __fdiv_rn(127.f, m);
  const float scale = __fmul_rn(c, m);
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64 + 64, columns wn*32 + 32
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
  for (int k0 = 0; k0 < kp; k0 += Q_BK) {
    for (int i = tid; i < Q_BN * Q_SLABS; i += Q_THREADS) {
      const int n = i / Q_SLABS, sl = i - n * Q_SLABS;
      cp_async16(bq + (sl * Q_BN + n) * 16,
                 w_t + static_cast<size_t>(n0 + n) * kp + k0 + 16 * sl);
    }
    cp_async_commit();
    for (int i = tid; i < Q_BM * Q_BK / 4; i += Q_THREADS) {
      const int r = i / (Q_BK / 4), k = 4 * (i - r * (Q_BK / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + k < kd) v = *reinterpret_cast<const float4*>(a_in + (row0 + r) * kd + k0 + k);
      *reinterpret_cast<char4*>(aq + ((k >> 4) * Q_BM + r) * 16 + (k & 15)) =
          make_char4(quantize(v.x, s), quantize(v.y, s), quantize(v.z, s), quantize(v.w, s));
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int sl = 0; sl < Q_SLABS; ++sl) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bq + (sl * Q_BN + wn * 32 + j * 16) * 16, 16);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
        wmma::load_matrix_sync(a, aq + (sl * Q_BM + wm * 64 + i * 16) * 16, 16);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(stg + (wm * 64 + i * 16) * Q_LDS + wn * 32 + j * 16, acc[i][j],
                              Q_LDS, wmma::mem_row_major);
  __syncthreads();
  float vmax = 0.f;
  for (int e = tid; e < Q_BM * Q_BN; e += Q_THREADS) {
    const int r = e >> 7, col = e & 127;
    const float v = __fmul_rn(__int2float_rn(stg[r * Q_LDS + col]), scale);
    a_out[(row0 + r) * HID + n0 + col] = v;
    vmax = fmaxf(vmax, fabsf(v));
  }
  if (gmax_out != nullptr) {
    vmax = block_max256(vmax);
    if (tid == 0) atomicMax(gmax_out + g, __float_as_int(vmax));
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int launch_chain(int variant, int batch, int d_in, const void* x, const void* w1,
                 const void* w2, const void* w3, float c1, float c2, float c3,
                 float* out, float* scratch, int* gmax, cudaStream_t st) {
  if (batch <= 0) return 0;
  if (batch % GROUP != 0 || d_in <= 0 || d_in > HID || d_in % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xf = static_cast<const float*>(x);
  cudaError_t err = cudaSuccess;
  if (variant == 0) {
    if ((err = allow_smem(chain_f32_kernel, F_SMEM)) != cudaSuccess) return static_cast<int>(err);
    chain_f32_kernel<<<batch / F_BM, F_THREADS, F_SMEM, st>>>(
        d_in, xf, static_cast<const float*>(w1), static_cast<const float*>(w2),
        static_cast<const float*>(w3), out);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == 1) {
    if ((err = allow_smem(chain_bf16_kernel, H_SMEM)) != cudaSuccess) return static_cast<int>(err);
    chain_bf16_kernel<<<batch / H_BM, H_THREADS, H_SMEM, st>>>(
        d_in, xf, static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
        static_cast<const bf16*>(w3), out);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != 2) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = batch / GROUP;
  if ((err = allow_smem(chain_int8_stage_kernel, Q_SMEM)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  // gmax: [3][groups]; row 0 is written whole by the absmax pass, rows 1-2
  // collect the stages' atomicMax from zero
  if ((err = cudaMemsetAsync(gmax + groups, 0, sizeof(int) * 2 * groups, st)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  chain_absmax_kernel<<<groups, 256, 0, st>>>(d_in, xf, gmax);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(HID / Q_BN, groups);
  float* a = scratch;
  float* b = scratch + static_cast<size_t>(batch) * HID;
  const signed char* ws[3] = {static_cast<const signed char*>(w1),
                              static_cast<const signed char*>(w2),
                              static_cast<const signed char*>(w3)};
  chain_int8_stage_kernel<<<grid, Q_THREADS, Q_SMEM, st>>>(d_in, xf, ws[0], c1, gmax,
                                                           gmax + groups, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chain_int8_stage_kernel<<<grid, Q_THREADS, Q_SMEM, st>>>(HID, a, ws[1], c2, gmax + groups,
                                                           gmax + 2 * groups, b);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chain_int8_stage_kernel<<<grid, Q_THREADS, Q_SMEM, st>>>(HID, b, ws[2], c3,
                                                           gmax + 2 * groups, nullptr, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chain
}  // namespace gfdm

// variant 0 f32, 1 bf16, 2 int8. x (batch, d_in) float32; w1 (d_in, 1152),
// w2, w3 (1152, 1152) float32 or bf16, or for int8 their transposes (1152,
// k) int8 with k zero-padded to a multiple of 64 and c1-3 each stage's
// inv / 127 in float32; out (batch, 1152) float32. int8 also takes scratch
// (2, batch, 1152) float32 and gmax (3, batch / 128) int32. batch must be a
// multiple of 128, d_in a multiple of 8 and at most 1152.
extern "C" int gfdm_chain(int variant, int batch, int d_in, const void* x, const void* w1,
                          const void* w2, const void* w3, float c1, float c2, float c3,
                          float* out, float* scratch, int* gmax, void* stream) {
  return gfdm::chain::launch_chain(variant, batch, d_in, x, w1, w2, w3, c1, c2, c3, out,
                                   scratch, gmax, static_cast<cudaStream_t>(stream));
}
