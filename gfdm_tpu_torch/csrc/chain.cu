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
// int8: x is quantized once, then each stage multiplies int8 on the
//   tensor cores and its epilogue quantizes its own output for the next
//   stage: four launches, no float32 intermediate.
//   - x's pass (chain_quantize_kernel): a cluster of 8 CTAs a group, 16
//     rows each held in registers (x read once); the CTAs' maxima are
//     exchanged through distributed shared memory, every CTA quantizes its
//     rows with the group's scale into an int8 plane whose rows are padded
//     with zeros to a multiple of 64 bytes (TMA rows are 16-byte multiples),
//     and rank 0 writes the group's max.
//   - a stage (chain_int8_stage_kernel): tiles of 128 rows (one group) x
//     192 columns, persistent; warpgroup 0 (one thread) keeps TMA loads of
//     128-deep int8 k-slabs of the activation (128 x 128) and of the
//     transposed weight (192 x 128) in a four-slot mbarrier ring, running
//     ahead into the next tile during the epilogue; warpgroups 1 and 2 each
//     run wgmma m64n192k32 (s8 x s8 -> s32, both operands in shared
//     memory) on 64 rows. Its epilogue computes out = float(acc) * (c *
//     max(m, 1e-20)). Stages 1 and 2 run as clusters of the 6 CTAs that
//     cover a group's 1,152 columns: each CTA sends its tile's max |acc|
//     to every peer's shared memory with an mbarrier arrival (rounding is
//     monotonic and the scale positive, so the group's max |out| is
//     fl(float(max |acc|) * scale)), every CTA derives the same m' and s' =
//     127 / max(m', 1e-20), quantizes its tile into a staged int8 tile and
//     stores it in 16-byte rows; rank 0 writes m' for the next stage's
//     dequant scale. Stage 3 writes float32 into out (8 bytes a lane).
//   Division and rounding are IEEE (no fast math, no contraction of x * s;
//   int32 sums are exact in any order), so the result equals the plain
//   version's bit for bit. The int8 weights come transposed, (1152, k) with
//   k zero-padded to a multiple of 64 (K-major, as s8 wgmma requires).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fma_gemm.cuh"
#include "hopper_gemm.cuh"

namespace gfdm {
namespace chain {

using bf16 = __nv_bfloat16;

constexpr int HID = 1152;   // width of every stage's output
constexpr int GROUP = 128;  // rows sharing one int8 activation scale
constexpr int KPAD = 64;    // the bf16 and int8 weights' k padding (kernels/chain.py _KPAD)

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
          hg::wgmma_m64n192k16(acc[q], hg::desc_step32(da + q * (8192 >> 4), s),
                               hg::desc_step32(db, s), (kt | s) != 0);
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
// int8: x quantized once, then one TMA + wgmma launch a stage
// ---------------------------------------------------------------------------
constexpr int QX_CL = 8;                    // CTAs (a cluster) quantizing one group of x
constexpr int QX_ROWS = GROUP / QX_CL;      // rows of x a CTA: 16
constexpr int QX_THREADS = 256;
constexpr int QX_PER = QX_ROWS * HID / 4 / QX_THREADS;  // float4 a thread at most: 18
constexpr int Q_BN = 192;                   // columns of a stage tile
constexpr int Q_NT = HID / Q_BN;            // column tiles of a group: the cluster, 6
constexpr int Q_SLAB = 128;                 // k of a TMA box row: 128 bytes of int8
constexpr int Q_STAGES = 4;                 // ring slots
constexpr int Q_THREADS = 384;              // warpgroup 0 loads, 1 and 2 multiply 64 rows each
constexpr int Q_OUT_LD = Q_BN + 16;         // pitch of the staged int8 tile: 16-byte rows,
                                            // 2-byte fragment stores free of bank conflicts
constexpr uint32_t Q_A_BYTES = GROUP * Q_SLAB;
constexpr uint32_t Q_B_BYTES = Q_BN * Q_SLAB;
static_assert(HID % Q_BN == 0 && Q_NT <= 8 && QX_PER * QX_THREADS * 4 == QX_ROWS * HID &&
                  Q_A_BYTES % 1024 == 0 && Q_B_BYTES % 1024 == 0,
              "int8 tiling");
constexpr size_t Q_SMEM =
    1024 + Q_STAGES * (Q_A_BYTES + Q_B_BYTES) + static_cast<size_t>(GROUP) * Q_OUT_LD;

__device__ __forceinline__ signed char quantize(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, s)), -127.f), 127.f);
  return static_cast<signed char>(static_cast<int>(q));
}

__device__ __forceinline__ float abs_max4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// q (rows, ld) int8 = the 128-row groups of a (rows, d) float32, each
// quantized with its absmax m: s = 127 / max(m, 1e-20), q = clip(rint(a
// s), -127, 127); columns d .. ld of q zero. A CTA holds 16 rows of a group
// in registers, so a is read once; a cluster of 8 CTAs, one group, settles
// m through distributed shared memory and rank 0 writes gmax[g]. d a
// multiple of 8 (<= 1152), ld a multiple of 16.
__global__ void __launch_bounds__(QX_THREADS)
chain_quantize_kernel(int d, int ld, const float* __restrict__ a, int* __restrict__ gmax,
                      signed char* __restrict__ q) {
  __shared__ int part[QX_THREADS / 32];  // the warps' maxima
  __shared__ int peer[QX_CL];            // the cluster's CTA maxima
  const int tid = threadIdx.x;
  const int g = blockIdx.x / QX_CL, rank = blockIdx.x % QX_CL;
  const size_t row0 = static_cast<size_t>(g) * GROUP + rank * QX_ROWS;
  const int n4 = QX_ROWS * d / 4, q4 = d / 4;
  const float4* src = reinterpret_cast<const float4*>(a + row0 * d);
  float4 v[QX_PER];
#pragma unroll
  for (int j = 0; j < QX_PER; ++j) {
    const int i = tid + j * QX_THREADS;
    v[j] = i < n4 ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float lm = 0.f;  // non-negative floats order as their bits
#pragma unroll
  for (int j = 0; j < QX_PER; ++j) lm = fmaxf(lm, abs_max4(v[j]));
  const int b = __reduce_max_sync(0xffffffffu, __float_as_int(lm));
  if ((tid & 31) == 0) part[tid >> 5] = b;
  __syncthreads();
  if (tid < QX_CL) {  // this CTA's max into slot `rank` of CTA `tid`
    int mb = part[0];
#pragma unroll
    for (int w = 1; w < QX_THREADS / 32; ++w) mb = max(mb, part[w]);
    hg::st_peer(hg::peer_addr(&peer[rank], tid), mb);
  }
  hg::cluster_sync();  // every slot written; no peer reads or writes this CTA after it
  int mb = peer[0];
#pragma unroll
  for (int p = 1; p < QX_CL; ++p) mb = max(mb, peer[p]);
  if (rank == 0 && tid == 0) gmax[g] = mb;
  const float s = __fdiv_rn(127.f, fmaxf(__int_as_float(mb), 1e-20f));
#pragma unroll
  for (int j = 0; j < QX_PER; ++j) {
    const int i = tid + j * QX_THREADS;
    if (i < n4) {
      const int r = i / q4, k = 4 * (i - r * q4);
      *reinterpret_cast<char4*>(q + (row0 + r) * ld + k) =
          make_char4(quantize(v[j].x, s), quantize(v[j].y, s), quantize(v[j].z, s),
                     quantize(v[j].w, s));
    }
  }
  const int pad8 = (ld - d) / 8;  // 8-byte chunks of zeros a row
  for (int i = tid; i < QX_ROWS * pad8; i += QX_THREADS) {
    const int r = i / pad8;
    *reinterpret_cast<uint2*>(q + (row0 + r) * ld + d + 8 * (i - r * pad8)) = make_uint2(0u, 0u);
  }
}

// One stage: out (rows, HID) = float(q @ W) * (c * max(gmax_in[g], 1e-20))
// for each 128-row group g, with map_a over q (int8, boxes 128 x 128) and
// map_b over W^T (HID, kd) int8 (boxes 192 x 128). Q8: out is the next
// stage's int8 operand, quantized with the group's max settled across the
// cluster (rank 0 writes it to gmax_out); else float32. Persistent: a CTA
// walks the 128 x 192 tiles t = blockIdx.x, + gridDim.x, ... (group t / 6,
// column tile t % 6); for Q8 the grid is whole clusters of 6, so cluster c
// takes groups c, c + clusters, ... and rank r column tile r. Warpgroup 0
// (one thread) keeps TMA loads of 128-deep k-slabs in a four-slot ring,
// running ahead into the next tile while the consumers store; warpgroups 1
// and 2 each run wgmma m64n192k32 (s8 -> s32) on 64 rows.
template <bool Q8>
__global__ void __launch_bounds__(Q_THREADS, 1)
chain_int8_stage_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b, int groups, int kd, float c,
                        const int* __restrict__ gmax_in, int* __restrict__ gmax_out,
                        void* __restrict__ out) {
  extern __shared__ unsigned char qsm[];
  __shared__ uint64_t full[Q_STAGES], empty[Q_STAGES];
  __shared__ uint64_t xbar[2];    // Q8: the cluster's tile maxima have arrived
  __shared__ int xmax[2][Q_NT];   // Q8: the tile maxima, slot = rank
  __shared__ int wmax[8];         // the consumer warps' maxima
  unsigned char* base = qsm + ((1024u - (hg::smem_addr(qsm) & 1023u)) & 1023u);
  signed char* sa = reinterpret_cast<signed char*>(base);  // [Q_STAGES][GROUP][Q_SLAB]
  signed char* sb = sa + Q_STAGES * Q_A_BYTES;               // [Q_STAGES][Q_BN][Q_SLAB]
  signed char* so = sb + Q_STAGES * Q_B_BYTES;               // [GROUP][Q_OUT_LD]
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < Q_STAGES; ++s) {
      hg::mbar_init(full + s, 1);   // the producer's expect_tx
      hg::mbar_init(empty + s, 8);  // one arrival a consumer warp
    }
    if (Q8) {
      hg::mbar_init(xbar, Q_NT);  // one arrival a CTA of the cluster
      hg::mbar_init(xbar + 1, Q_NT);
    }
    hg::mbar_init_fence();
  }
  if (Q8) {
    hg::cluster_sync();  // no peer arrives on a barrier before it is initialised
  } else {
    __syncthreads();
  }
  const int tiles = groups * Q_NT;
  const int nk = (kd + Q_SLAB - 1) / Q_SLAB;  // the last slab's k >= kd arrive as zeros
  if (wg == 0) {  // producer: one thread starts every load
    hg::setmaxnreg_dec<40>();
    if (tid == 0) {
      hg::tma_prefetch_map(&map_a);
      hg::tma_prefetch_map(&map_b);
      hg::Ring r;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / Q_NT * GROUP, n0 = t % Q_NT * Q_BN;
        for (int kt = 0; kt < nk; ++kt) {
          hg::mbar_wait(empty + r.slot, r.phase ^ 1u);
          hg::mbar_expect_tx(full + r.slot, Q_A_BYTES + Q_B_BYTES);
          hg::tma_load_2d(sa + r.slot * Q_A_BYTES, &map_a, full + r.slot, kt * Q_SLAB, m0);
          hg::tma_load_2d(sb + r.slot * Q_B_BYTES, &map_b, full + r.slot, kt * Q_SLAB, n0);
          r.advance<Q_STAGES>();
        }
      }
    }
    if (Q8) hg::cluster_sync();  // as the consumers' last one
    return;
  }
  hg::setmaxnreg_inc<232>();
  const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31, ct = tid - 128;
  const int qi = lane & 3;
  const uint32_t rank = Q8 ? hg::cluster_rank() : 0u;
  int acc[96];  // rows 64 cw + 16 warp + lane / 4 + 8 h, columns 8 j + 2 qi + e
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0;
  hg::Ring r;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int g = t / Q_NT, n0 = t % Q_NT * Q_BN;
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      hg::mbar_wait(full + r.slot, r.phase);
      const uint64_t da = hg::smem_desc_sw128(sa + r.slot * Q_A_BYTES + 64 * Q_SLAB * cw);
      const uint64_t db = hg::smem_desc_sw128(sb + r.slot * Q_B_BYTES);
      hg::wgmma_fence();
#pragma unroll
      for (int s = 0; s < Q_SLAB / 32; ++s) {
        hg::wgmma_m64n192k32_s8(acc, hg::desc_step32(da, s), hg::desc_step32(db, s),
                                (kt | s) != 0);
      }
      hg::wgmma_commit();
      if (kt > 0) {  // the previous slab's products are done: free its slot
        hg::wgmma_wait<1>();
        if (lane == 0) hg::mbar_arrive(empty + prev);
      }
      prev = r.slot;
      r.advance<Q_STAGES>();
    }
    hg::wgmma_wait<0>();
    hg::fence_regs(acc);
    if (lane == 0) hg::mbar_arrive(empty + prev);
    const float scale = __fmul_rn(c, fmaxf(__int_as_float(gmax_in[g]), 1e-20f));
    if (!Q8) {  // 8 bytes a lane, a full 32-byte sector a row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row =
            static_cast<size_t>(g) * GROUP + 64 * cw + 16 * warp + (lane >> 2) + 8 * h;
        float* dst = static_cast<float*>(out) + row * HID + n0 + 2 * qi;
#pragma unroll
        for (int j = 0; j < Q_BN / 8; ++j) {
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), scale),
                          __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), scale));
        }
      }
      continue;
    }
    // rounding is monotonic and scale > 0, so the tile's max |out| is
    // fl(float(max |acc|) * scale): the integer max is carried
    int amax = 0;
#pragma unroll
    for (int i = 0; i < 96; ++i) amax = max(amax, abs(acc[i]));
    amax = __reduce_max_sync(0xffffffffu, amax);
    // the group's max: each CTA's into slot `rank` of every CTA of the
    // cluster, then an arrival on its barrier; slots and barriers
    // alternate between tiles (a CTA writes slot set p again only after
    // every peer has arrived for the tile between, so after each has read
    // set p)
    const int par = it & 1;
    if (lane == 0) wmax[4 * cw + warp] = amax;
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumer warps
    if (ct < 32) {
      int mb = wmax[0];
#pragma unroll
      for (int w = 1; w < 8; ++w) mb = max(mb, wmax[w]);
      if (lane < Q_NT) {
        hg::st_peer(hg::peer_addr(&xmax[par][rank], lane), mb);
        hg::mbar_arrive_peer(hg::peer_addr(xbar + par, lane));
      }
    }
    hg::mbar_wait_cluster(xbar + par, (it >> 1) & 1);
    int mb = 0;
#pragma unroll
    for (int p = 0; p < Q_NT; ++p) mb = max(mb, static_cast<volatile int*>(xmax[par])[p]);
    const float mv = __fmul_rn(__int2float_rn(mb), scale);  // max |out| over the group
    const float s_next = __fdiv_rn(127.f, fmaxf(mv, 1e-20f));
    if (rank == 0 && ct == 0) gmax_out[g] = __float_as_int(mv);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      signed char* dst = so + (64 * cw + 16 * warp + (lane >> 2) + 8 * h) * Q_OUT_LD + 2 * qi;
#pragma unroll
      for (int j = 0; j < Q_BN / 8; ++j) {
        *reinterpret_cast<char2*>(dst + 8 * j) =
            make_char2(quantize(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), scale), s_next),
                       quantize(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), scale), s_next));
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    // 16-byte rows out; the next tile's first consumer barrier comes after
    // every thread's copy, before so is written again
    signed char* qo = static_cast<signed char*>(out) + static_cast<size_t>(g) * GROUP * HID + n0;
#pragma unroll
    for (int i = ct; i < GROUP * Q_BN / 16; i += 256) {
      const int row = i / (Q_BN / 16), c16 = i - row * (Q_BN / 16);
      *reinterpret_cast<uint4*>(qo + static_cast<size_t>(row) * HID + 16 * c16) =
          *reinterpret_cast<const uint4*>(so + row * Q_OUT_LD + 16 * c16);
    }
  }
  if (Q8) hg::cluster_sync();  // no CTA leaves while a peer may still write to it
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

// A launch of `grid` CTAs in clusters of `cluster` (1: none); attr holds
// the cluster attribute the config points to.
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int grid, int threads, size_t smem,
                                  int cluster, cudaStream_t st) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

// Launch `kernel` on `grid` CTAs in clusters of `cluster` (1: none).
template <typename... P, typename... A>
cudaError_t launch_ex(void (*kernel)(P...), int grid, int threads, size_t smem, int cluster,
                      cudaStream_t st, A... args) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, grid, threads, smem, cluster, st);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Clusters of the int8 stage (Q_NT CTAs of Q_SMEM each) that the card
// holds at once; 0 if none fits. Clusters sit within a GPC, so this can
// leave SMs idle.
int int8_clusters() {
  static int cached_dev = -1, cached = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev == cached_dev) return cached;
  const auto kernel = chain_int8_stage_kernel<true>;
  if (allow_smem(kernel, Q_SMEM) != cudaSuccess) return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, Q_NT * 256, Q_THREADS, Q_SMEM, Q_NT, 0);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &cfg) !=
      cudaSuccess) {
    return 0;
  }
  cached_dev = dev;
  cached = n;
  return n;
}

// One int8 chain call's operands. q0, q1: (batch, HID) int8 planes; gmax
// (3, batch / 128): each stage's input group maxima (as float bits).
struct Int8Call {
  int batch, d_in, lda;  // lda: q0's pitch while it holds x, d_in rounded up to KPAD
  const float* x;
  const signed char* w[3];  // W^T (HID, k), k padded to KPAD
  float c[3];
  float* out;
  signed char* q0;
  signed char* q1;
  int* gmax;
};

// stage s (0-2) from a (pitch lda) into dst: int8 (q8) or float32
cudaError_t int8_stage(bool q8, const Int8Call& k, int s, const signed char* a, int lda,
                       void* dst, cudaStream_t st) {
  const int groups = k.batch / GROUP;
  const int kd = s == 0 ? k.d_in : HID;
  CUtensorMap map_a, map_b;
  cudaError_t err = hg::tma_map_s8(&map_a, a, k.batch, kd, lda, GROUP);
  if (err == cudaSuccess) err = hg::tma_map_s8(&map_b, k.w[s], HID, kd, s == 0 ? k.lda : HID, Q_BN);
  if (err != cudaSuccess) return err;
  const int* g_in = k.gmax + s * groups;
  int* g_out = s < 2 ? k.gmax + (s + 1) * groups : nullptr;
  if (q8) {
    const int clusters = int8_clusters();
    if (clusters == 0) return cudaErrorInvalidConfiguration;
    const auto kernel = chain_int8_stage_kernel<true>;
    if ((err = allow_smem(kernel, Q_SMEM)) != cudaSuccess) return err;
    return launch_ex(kernel, (groups < clusters ? groups : clusters) * Q_NT, Q_THREADS, Q_SMEM,
                     Q_NT, st, map_a, map_b, groups, kd, k.c[s], g_in, g_out, dst);
  }
  const int tiles = groups * Q_NT, sms = sm_count(), grid = tiles < sms ? tiles : sms;
  const auto kernel = chain_int8_stage_kernel<false>;
  if ((err = allow_smem(kernel, Q_SMEM)) != cudaSuccess) return err;
  return launch_ex(kernel, grid, Q_THREADS, Q_SMEM, 1, st, map_a, map_b, groups, kd, k.c[s],
                   g_in, g_out, dst);
}

constexpr int INT8_LAUNCHES = 4;

// Launch i of the int8 chain: x's pass into q0 (pitch lda), stage 1 q0 ->
// q1, stage 2 q1 -> q0 (x's copy is spent), stage 3 q0 -> out.
cudaError_t int8_launch(int i, const Int8Call& k, cudaStream_t st) {
  switch (i) {
    case 0:
      return launch_ex(chain_quantize_kernel, k.batch / GROUP * QX_CL, QX_THREADS, 0, QX_CL, st,
                       k.d_in, k.lda, k.x, k.gmax, k.q0);
    case 1:
      return int8_stage(true, k, 0, k.q0, k.lda, k.q1, st);
    case 2:
      return int8_stage(true, k, 1, k.q1, HID, k.q0, st);
    case 3:
      return int8_stage(false, k, 2, k.q0, HID, k.out, st);
    default:
      return cudaErrorInvalidValue;
  }
}

int chain_variant(int variant, int part, int batch, int d_in, const void* x, const void* w1,
                  const void* w2, const void* w3, float c1, float c2, float c3, float* out,
                  void* scratch, int* gmax, cudaStream_t st) {
  const float* xf = static_cast<const float*>(x);
  const size_t plane = static_cast<size_t>(batch) * HID;
  const int kp = (d_in + KPAD - 1) / KPAD * KPAD;
  cudaError_t err = cudaSuccess;
  if (variant == 2) {
    if (part < -1 || part >= INT8_LAUNCHES) return static_cast<int>(cudaErrorInvalidValue);
    signed char* q0 = static_cast<signed char*>(scratch);
    const Int8Call k{batch, d_in, kp, xf,
                     {static_cast<const signed char*>(w1), static_cast<const signed char*>(w2),
                      static_cast<const signed char*>(w3)},
                     {c1, c2, c3}, out, q0, q0 + plane, gmax};
    for (int i = part < 0 ? 0 : part; i < (part < 0 ? INT8_LAUNCHES : part + 1); ++i) {
      if ((err = int8_launch(i, k, st)) != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
  }
  if (part != -1) return static_cast<int>(cudaErrorInvalidValue);
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
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_chain(int variant, int part, int batch, int d_in, const void* x, const void* w1,
                 const void* w2, const void* w3, float c1, float c2, float c3, float* out,
                 void* scratch, int* gmax, cudaStream_t st) {
  (void)cudaGetLastError();  // report this call's error only (earlier calls reported theirs)
  if (batch <= 0) return 0;
  if (batch % GROUP != 0 || d_in <= 0 || d_in > HID || d_in % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rc = chain_variant(variant, part, batch, d_in, x, w1, w2, w3, c1, c2, c3, out,
                               scratch, gmax, st);
  if (rc != 0) (void)cudaGetLastError();  // a refused launch leaves no error behind
  return rc;
}

}  // namespace chain
}  // namespace gfdm

// variant 0 f32, 1 bf16, 2 int8. x (batch, d_in) float32; w1 (d_in,
// 1152), w2, w3 (1152, 1152) float32; for bf16 and int8 their transposes
// (1152, k) with k zero-padded to a multiple of 64, bf16 or int8 (for int8
// c1-3 are each stage's inv / 127 in float32); out (batch, 1152) float32.
// scratch: f32 (2, batch, 1152) float32, bf16 (batch, 1152) bf16, int8 (2,
// batch, 1152) int8; int8 also gmax (3, batch / 128) int32. batch must be a multiple of 128, d_in a
// multiple of 8 and at most 1152. Launches: f32 3, bf16 4, int8 4.
// part: -1 runs every launch of the call; for int8, i >= 0 runs launch i
// alone (in order on one stream, they make the call: the per-launch
// timings).
extern "C" int gfdm_chain(int variant, int part, int batch, int d_in, const void* x,
                          const void* w1, const void* w2, const void* w3, float c1, float c2,
                          float c3, float* out, void* scratch, int* gmax, void* stream) {
  return gfdm::chain::launch_chain(variant, part, batch, d_in, x, w1, w2, w3, c1, c2, c3, out,
                                   scratch, gmax, static_cast<cudaStream_t>(stream));
}

// The int8 stage's cluster: out[0] clusters the card holds at once
// (cudaOccupancyMaxActiveClusters), out[1] CTAs a cluster, out[2] dynamic
// shared memory a CTA (bytes). Returns 0, or an error if none fits.
extern "C" int gfdm_chain_int8_clusters(int* out) {
  (void)cudaGetLastError();
  out[0] = gfdm::chain::int8_clusters();
  out[1] = gfdm::chain::Q_NT;
  out[2] = static_cast<int>(gfdm::chain::Q_SMEM);
  if (out[0] > 0) return 0;
  const cudaError_t err = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
}
