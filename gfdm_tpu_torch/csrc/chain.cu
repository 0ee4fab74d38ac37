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
// Design.
// f32: one launch a stage (three), each a GEMM over the batch with its
//   activation in device memory (x -> scratch[0] -> scratch[1] -> out,
//   302 MB a float32 intermediate at B = 65,536: 0.5 ms of bytes against a
//   7.3 ms bound). The GEMM body is fma_gemm.cuh's (shared with the factored
//   receiver's estimator): a CTA of 128 threads computes a 64 x 128 output
//   tile, each thread an 8 x 8 block; k runs in 16-deep tiles through a
//   four-slot cp.async ring (48 KB); a k-tile past kd is zero-filled by the
//   copy (src-size 0). Three CTAs an SM at up to 170 registers, so no spill
//   (256 threads capped at 128 registers for two CTAs spill; 128 x 128
//   tiles, 8 x 16 and 16 x 8 blocks, 8- or 32-deep k-tiles and other rings
//   ran slower). Every output element is one FMA chain over k in order,
//   from zero, with no split-k: bit-equal to cuBLAS's SGEMM at these
//   shapes. FMA on CUDA cores, no TF32.
// bf16: a rounding pass writes bf16(x) (nearest even) into the scratch,
//   then one launch a stage (four launches): stage 1 writes its bf16 output
//   into the bytes of out, stage 2 into the scratch, stage 3 float32 into
//   out. Each stage is a persistent TMA + wgmma GEMM (hopper_gemm.cuh):
//   256 x 192 output tiles (L2 traffic 110 FLOP a byte, against 32 for
//   the one-CTA kernel this replaces); warpgroup 0 (one thread) starts TMA
//   loads of 64-deep k-slabs of the activation (256 x 64) and of the
//   transposed weight (192 x 64, K-major, transposed once on the host) into
//   a four-slot ring on mbarriers and gives its registers away
//   (setmaxnreg); two consumer warpgroups each run wgmma m64n192k16 (bf16
//   into float32, both operands in shared memory) for 128 rows, 192
//   accumulator registers a thread, keeping one slab's products in flight
//   while the next is started. The sum of a tile stays in the wgmma
//   accumulator over all of k. Rows of bf16(x) and of W1^T are padded to a
//   multiple of 64 (a 1,872-byte row would split each 128-byte TMA row
//   over two lines; TMA still zero-fills k >= 936). The epilogue is not
//   overlapped with the next tile's products: the tensor cores wait while
//   the fragment goes to device memory, 16 bytes a lane for bf16 (after a
//   4 x 4 exchange in each quad), 8 for float32.
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

#include "fma_gemm.cuh"
#include "hopper_gemm.cuh"

namespace gfdm {
namespace chain {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int HID = 1152;   // width of every stage's output
constexpr int GROUP = 128;  // rows sharing one int8 activation scale
constexpr int KPAD = 64;    // the bf16 and int8 weights' k padding (kernels/chain.py _KPAD)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

using fg::cp_async_commit;
using fg::cp_async_wait;

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
// f32: one launch a stage, a register-blocked FMA GEMM on CUDA cores
// ---------------------------------------------------------------------------
static_assert(HID % fg::BN == 0, "f32 tiling");

// k-tile k0 into a ring slot: A rows m0 .. m0 + 64 (pitch kd) and W rows
// k0 .. k0 + 16, columns n0 .. n0 + 128 (pitch HID); k >= kd zero
__device__ __forceinline__ void f32_load_tile(float* slot, const float* a, const float* w, int kd,
                                              size_t m0, int n0, int k0, int tid) {
  float* as = slot;
  float* ws = slot + fg::BM * fg::BK;
#pragma unroll
  for (int i = 0; i < fg::BM * fg::BK / 4 / fg::THREADS; ++i) {
    const int c = tid + i * fg::THREADS, r = c >> 2, k = k0 + 4 * (c & 3);
    fg::cp_async16_zfill(as + r * fg::BK + 4 * (c & 3), k < kd ? a + (m0 + r) * kd + k : a,
                         k < kd);
  }
#pragma unroll
  for (int i = 0; i < fg::BK * fg::BN / 4 / fg::THREADS; ++i) {
    const int c = tid + i * fg::THREADS, r = c >> 5, col = 4 * (c & 31);
    const bool ok = k0 + r < kd;
    fg::cp_async16_zfill(ws + r * fg::BN + col,
                         ok ? w + static_cast<size_t>(k0 + r) * HID + n0 + col : w, ok);
  }
}

// c[m0 .., n0 ..] = a (rows, kd) @ w (kd, HID), a 64 x 128 tile a CTA
__global__ void __launch_bounds__(fg::THREADS, 3)
chain_f32_stage_kernel(int kd, const float* __restrict__ a, const float* __restrict__ w,
                       float* __restrict__ c) {
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t m0 = static_cast<size_t>(blockIdx.y) * fg::BM;
  const int n0 = blockIdx.x * fg::BN;
  float acc[fg::TM][fg::TN];
  fg::mainloop(acc, fsm, (kd + fg::BK - 1) / fg::BK, [&](float* slot, int k0) {
    f32_load_tile(slot, a, w, kd, m0, n0, k0, tid);
  });
#pragma unroll
  for (int i = 0; i < fg::TM; ++i) {
    float* row = c + (m0 + ty + fg::TY * i) * HID + n0 + 4 * tx;
    *reinterpret_cast<float4*>(row) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 64) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// ---------------------------------------------------------------------------
// bf16: x rounded to bf16 in one pass, then one launch a stage on TMA and
// wgmma (hopper_gemm.cuh)
// ---------------------------------------------------------------------------
constexpr int H_BM = 256, H_BN = 192, H_STAGES = 4;
constexpr int H_NT = HID / H_BN;  // column tiles of a row tile
constexpr int H_CONSUMERS = 2;    // warpgroups, 128 rows of the tile each
constexpr int H_THREADS = 128 * (1 + H_CONSUMERS);  // warpgroup 0 loads
constexpr uint32_t H_A_BYTES = H_BM * hg::SLAB * sizeof(bf16);
constexpr uint32_t H_B_BYTES = H_BN * hg::SLAB * sizeof(bf16);
static_assert(HID % H_BN == 0 && H_A_BYTES % 1024 == 0 && H_B_BYTES % 1024 == 0, "bf16 tiling");
constexpr size_t H_SMEM =
    1024 + H_STAGES * (H_A_BYTES + H_B_BYTES) + 2 * H_STAGES * sizeof(uint64_t);

// y[r, k] = bf16(x[r, k]) (nearest even) for k < d_in, rows of y ldy apart;
// n4 = rows * d_in / 4
__global__ void __launch_bounds__(256)
chain_round_bf16_kernel(size_t n4, int d_in, int ldy, const float4* __restrict__ x,
                        bf16* __restrict__ y) {
  const int q4 = d_in / 4;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / q4;
    const float4 v = x[i];
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(y + r * ldy + 4 * (i - r * q4)) =
        make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                   *reinterpret_cast<const unsigned*>(&hi));
  }
}

__device__ __forceinline__ unsigned pick4(const unsigned (&v)[4], int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : (i == 2 ? v[2] : v[3]));
}

// c (rows, HID) = a (rows, kd) @ w, with map_a over a (bf16, boxes 256 x 64;
// rows past `rows` arrive as zeros and are not stored) and map_b over w^T
// (HID, kd) bf16 (boxes 192 x 64); c bf16 (rounded, nearest even) or
// float32. Persistent: a CTA walks the 256 x 192 tiles blockIdx.x, +
// gridDim.x, ..., column tile fastest, so the CTAs in flight share their
// rows of a in L2. Warpgroup 0 gives its registers to the two consumer
// warpgroups (setmaxnreg), each holding a 128 x 192 float32 sum: 192
// registers a thread.
template <bool F32_OUT>
__global__ void __launch_bounds__(H_THREADS, 1)
chain_bf16_stage_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b, int rows, int kd,
                        void* __restrict__ c) {
  extern __shared__ unsigned char hsm[];
  unsigned char* base = hsm + ((1024u - (hg::smem_addr(hsm) & 1023u)) & 1023u);
  bf16* sa = reinterpret_cast<bf16*>(base);                         // [H_STAGES][H_BM][SLAB]
  bf16* sb = reinterpret_cast<bf16*>(base + H_STAGES * H_A_BYTES);  // [H_STAGES][H_BN][SLAB]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + H_STAGES * (H_A_BYTES + H_B_BYTES));
  uint64_t* empty = full + H_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < H_STAGES; ++s) {
      hg::mbar_init(full + s, 1);                 // the producer's expect_tx
      hg::mbar_init(empty + s, 4 * H_CONSUMERS);  // one arrival a consumer warp
    }
    hg::mbar_init_fence();
  }
  __syncthreads();
  const int tiles = (rows + H_BM - 1) / H_BM * H_NT;
  const int nk = (kd + hg::SLAB - 1) / hg::SLAB;  // the last slab's k >= kd arrive as zeros
  if (wg == 0) {  // producer: one thread starts every load
    hg::setmaxnreg_dec<40>();
    if (tid == 0) {
      hg::tma_prefetch_map(&map_a);
      hg::tma_prefetch_map(&map_b);
      hg::Ring r;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / H_NT * H_BM, n0 = t % H_NT * H_BN;
        for (int kt = 0; kt < nk; ++kt) {
          hg::mbar_wait(empty + r.slot, r.phase ^ 1u);
          hg::mbar_expect_tx(full + r.slot, H_A_BYTES + H_B_BYTES);
          hg::tma_load_2d(sa + r.slot * H_BM * hg::SLAB, &map_a, full + r.slot, kt * hg::SLAB, m0);
          hg::tma_load_2d(sb + r.slot * H_BN * hg::SLAB, &map_b, full + r.slot, kt * hg::SLAB, n0);
          r.advance<H_STAGES>();
        }
      }
    }
    return;
  }
  hg::setmaxnreg_inc<232>();
  const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  float acc[2][96];  // rows 128 cw + 64 q + ..., q = 0, 1
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[q][i] = 0.f;
  hg::Ring r;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / H_NT * H_BM, n0 = t % H_NT * H_BN;
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      hg::mbar_wait(full + r.slot, r.phase);
      const uint64_t da = hg::smem_desc_sw128(sa + (r.slot * H_BM + 128 * cw) * hg::SLAB);
      const uint64_t db = hg::smem_desc_sw128(sb + r.slot * H_BN * hg::SLAB);
      hg::wgmma_fence();
#pragma unroll
      for (int s = 0; s < hg::SLAB / 16; ++s) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {  // 64 rows = 8 KB of the swizzled A tile
          hg::wgmma_m64n192k16(acc[q], hg::desc_k16(da + q * (8192 >> 4), s),
                               hg::desc_k16(db, s), (kt | s) != 0);
        }
      }
      hg::wgmma_commit();
      if (kt > 0) {  // the previous slab's products are done: free its slot
        hg::wgmma_wait<1>();
        if (lane == 0) hg::mbar_arrive(empty + prev);
      }
      prev = r.slot;
      r.advance<H_STAGES>();
    }
    hg::wgmma_wait<0>();
    hg::fence_regs(acc[0]);
    hg::fence_regs(acc[1]);
    if (lane == 0) hg::mbar_arrive(empty + prev);
    // the fragment: acc[q][4 j + 2 h + e] is row 64 q + 16 warp + lane / 4 +
    // 8 h, column 8 j + 2 (lane % 4) + e of the warpgroup's 128 x 192
    const int qi = lane & 3;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 128 * cw + 64 * q + 16 * warp + (lane >> 2) + 8 * h;
        if (row >= rows) continue;
        if (F32_OUT) {  // 8 bytes a lane, a full 32-byte sector a row
          float* dst = static_cast<float*>(c) + static_cast<size_t>(row) * HID + n0 + 2 * qi;
#pragma unroll
          for (int j = 0; j < H_BN / 8; ++j) {
            *reinterpret_cast<float2*>(dst + 8 * j) =
                make_float2(acc[q][4 * j + 2 * h], acc[q][4 * j + 2 * h + 1]);
          }
          continue;
        }
        // bf16: a 4 x 4 exchange within the quad gives lane qi the four
        // pairs of column chunk 4 g + qi, 8 columns: one 16-byte store
        bf16* dst = static_cast<bf16*>(c) + static_cast<size_t>(row) * HID + n0 + 8 * qi;
#pragma unroll
        for (int g = 0; g < H_BN / 32; ++g) {
          unsigned v[4], o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * g + e;
            const __nv_bfloat162 p =
                __floats2bfloat162_rn(acc[q][4 * j + 2 * h], acc[q][4 * j + 2 * h + 1]);
            v[e] = *reinterpret_cast<const unsigned*>(&p);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // from lane qi + r: its pair of chunk 4 g + qi
            const int src = (qi + r) & 3;
            const unsigned got =
                __shfl_sync(0xffffffffu, pick4(v, (qi - r) & 3), (lane & ~3) | src);
#pragma unroll
            for (int p = 0; p < 4; ++p) o[p] = p == src ? got : o[p];
          }
          *reinterpret_cast<uint4*>(dst + 32 * g) = make_uint4(o[0], o[1], o[2], o[3]);
        }
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

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 1;
  }
  return n;
}

cudaError_t f32_stage(int batch, int kd, const float* a, const void* w, float* c,
                      cudaStream_t st) {
  chain_f32_stage_kernel<<<dim3(HID / fg::BN, batch / fg::BM), fg::THREADS, fg::SMEM, st>>>(
      kd, a, static_cast<const float*>(w), c);
  return cudaGetLastError();
}

// c = a (batch, kd; pitch lda) @ w, w given as w^T (HID, kd; pitch ldw)
template <bool F32_OUT>
cudaError_t bf16_stage(int batch, int kd, const bf16* a, int lda, const void* w_t, int ldw,
                       void* c, cudaStream_t st) {
  CUtensorMap map_a, map_b;
  cudaError_t err = hg::tma_map_bf16(&map_a, a, batch, kd, lda, H_BM);
  if (err == cudaSuccess) err = hg::tma_map_bf16(&map_b, w_t, HID, kd, ldw, H_BN);
  if (err == cudaSuccess) err = allow_smem(chain_bf16_stage_kernel<F32_OUT>, H_SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = (batch + H_BM - 1) / H_BM * H_NT, sms = sm_count();
  const int grid = tiles < sms ? tiles : sms;
  chain_bf16_stage_kernel<F32_OUT><<<grid, H_THREADS, H_SMEM, st>>>(map_a, map_b, batch, kd, c);
  return cudaGetLastError();
}

int launch_chain(int variant, int batch, int d_in, const void* x, const void* w1,
                 const void* w2, const void* w3, float c1, float c2, float c3,
                 float* out, void* scratch, int* gmax, cudaStream_t st) {
  if (batch <= 0) return 0;
  if (batch % GROUP != 0 || d_in <= 0 || d_in > HID || d_in % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xf = static_cast<const float*>(x);
  const size_t plane = static_cast<size_t>(batch) * HID;
  cudaError_t err = cudaSuccess;
  if (variant == 0) {  // x -> scratch[0] -> scratch[1] -> out
    float* s0 = static_cast<float*>(scratch);
    float* s1 = s0 + plane;
    if ((err = allow_smem(chain_f32_stage_kernel, fg::SMEM)) != cudaSuccess ||
        (err = f32_stage(batch, d_in, xf, w1, s0, st)) != cudaSuccess ||
        (err = f32_stage(batch, HID, s0, w2, s1, st)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    return static_cast<int>(f32_stage(batch, HID, s1, w3, out, st));
  }
  if (variant == 1) {
    // x -> bf16(x) in scratch -> stage 1 into out's first half (bf16) ->
    // stage 2 into scratch -> stage 3 into out (float32): no stage reads
    // the buffer it writes. bf16(x) and w1^T have rows kp apart: every TMA
    // row starts on a 128-byte line
    const int kp = (d_in + KPAD - 1) / KPAD * KPAD;
    bf16* sc = static_cast<bf16*>(scratch);
    bf16* ob = reinterpret_cast<bf16*>(out);
    chain_round_bf16_kernel<<<8 * sm_count(), 256, 0, st>>>(
        static_cast<size_t>(batch) * d_in / 4, d_in, kp, reinterpret_cast<const float4*>(xf), sc);
    if ((err = cudaGetLastError()) != cudaSuccess ||
        (err = bf16_stage<false>(batch, d_in, sc, kp, w1, kp, ob, st)) != cudaSuccess ||
        (err = bf16_stage<false>(batch, HID, ob, HID, w2, HID, sc, st)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    return static_cast<int>(bf16_stage<true>(batch, HID, sc, HID, w3, HID, out, st));
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
  float* a = static_cast<float*>(scratch);
  float* b = a + plane;
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
// w2, w3 (1152, 1152) float32; for bf16 and int8 their transposes (1152,
// k) with k zero-padded to a multiple of 64, bf16 or int8 (for int8 c1-3
// are each stage's inv / 127 in float32); out (batch, 1152) float32. scratch: f32 and int8 (2, batch,
// 1152) float32, bf16 (batch, 1152) bf16; int8 also gmax (3, batch / 128)
// int32. batch must be a multiple of 128, d_in a multiple of 8 and at most
// 1152. Launches: f32 3, bf16 4, int8 4.
extern "C" int gfdm_chain(int variant, int batch, int d_in, const void* x, const void* w1,
                          const void* w2, const void* w3, float c1, float c2, float c3,
                          float* out, void* scratch, int* gmax, void* stream) {
  return gfdm::chain::launch_chain(variant, batch, d_in, x, w1, w2, w3, c1, c2, c3, out,
                                   scratch, gmax, static_cast<cudaStream_t>(stream));
}
