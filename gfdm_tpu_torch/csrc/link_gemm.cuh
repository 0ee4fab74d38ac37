// Staged tensor-core Gauss products of the link and the dense receiver
// (link.cu only).
//
// One engine, gauss_tile, computes a BM x BN tile (128 bursts x 64 output
// columns) of the complex product y = x @ W with W's Gauss stack
// [Wr; Wi; Wr + Wi] (3 n_in, n_out), as the host builds it:
//   P1 = xr @ Wr,  P2 = xi @ Wi,  P3 = (xr + xi) @ (Wr + Wi)
//   yr = P1 - P2,  yi = P3 - P1 - P2
// k runs in slabs of BK = 32. Each slab's activation tile (both planes,
// float32) and the three planes of the operator slab arrive by cp.async
// into a ring of two slots, so the next slab's copies overlap this slab's
// products. A slab edge past n_in, n_out or the batch is zero-filled by the
// copy itself (cp.async's src-size), so no stack is padded on the host. The
// products run on tensor cores through wmma:
//   float32 stacks: 3xTF32 (TF32 on purpose). Each operand x is split into
//     hi = tf32(x) and lo = tf32(x - hi) (cvt.rna: nearest, ties away), and
//     every product accumulates lo*hi + hi*lo, then hi*hi, in float32
//     m16n16k8 fragments: about 1e-7 relative a product, float32's level.
//     One-pass TF32 (about 5e-4) is not used anywhere.
//   bf16 stacks (the IC operator; every stack with dtype "bfloat16"): the
//     activations are rounded to bf16 (nearest even), the sum plane as
//     bf16(bf16(xr) + bf16(xi)), as the JAX package's _gdot casts them;
//     m16n16k16 bf16 fragments, float32 sums; or (F64, for an output that
//     the next stage rounds to bf16) the same exact products summed in
//     float64 on the FP64 tensor cores (mma.m8n8k4.f64), rounded once.
// The tile's yr and yi land in shared memory (float32, pitch LDO) for the
// caller's epilogue. Eight warps each own 32 rows x 32 columns of the tile:
// 2 x 2 fragments for each of P1, P2, P3.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

#include "gfdm_common.cuh"

namespace gfdm {
namespace lg {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int WM = 32, WN = 32;            // a warp's share of the tile
constexpr int FI = WM / 16, FJ = WN / 16;  // its 16 x 16 fragments
constexpr int WARPS_N = BN / WN;
constexpr int THREADS = BM / WM * WARPS_N * 32;
constexpr int LDA = BK + 4;   // float32 activation pitch (fragment loads conflict-free)
constexpr int LDAH = BK + 8;  // bf16 activation pitch
constexpr int LDO = BN + 4;   // float32 output pitch
constexpr int LDB = BN + 8;   // operator slab pitch (float: 8 mod 32 words; bf16: 36 words)
constexpr size_t A_BYTES = sizeof(float) * 2 * BM * LDA;
constexpr size_t AH_BYTES = sizeof(bf16) * 3 * BM * LDAH;
constexpr size_t OUT_BYTES = sizeof(float) * 2 * BM * LDO;

template <typename W>
__host__ __device__ constexpr size_t slot_bytes() { return A_BYTES + sizeof(W) * 3 * BK * LDB; }
// the two ring slots, then (bf16) the rounded activation planes
template <typename W>
__host__ __device__ constexpr size_t ring_bytes() {
  return 2 * slot_bytes<W>() + (sizeof(W) == 2 ? AH_BYTES : 0);
}
static_assert(OUT_BYTES <= 2 * slot_bytes<bf16>(), "the output staging reuses the ring");

// An activation: row r, plane q (0 re, 1 im), column k at
// p[r * ld + q * im + k]. Field order mirrors kernels/cuda_lib.py::Act.
struct Act {
  const float* p;
  int ld, im, n;
  __device__ bool vec() const {  // every row start 16-byte aligned
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ld % 4 == 0 && im % 4 == 0 &&
           n % 4 == 0;
  }
};

// Sizes and buffers of one call of the staged stages: the link's (payload
// in, data estimate out) or the dense receiver's (bursts in, channel,
// symbols out). Field order mirrors kernels/cuda_lib.py::LinkIO.
struct LinkIO {
  const float* data;      // (B, 2 n_data) payload (link)
  float* out;             // (B, 2 n_data) data estimate (link)
  float* met;             // (B, met_w) metrics rows [snr | cnrs | 0-pad]
  float* f;               // (B, 2N) the link's payload block; later IC decisions
  float* y;               // (B, 2N) equalized spectrum Y; later IC decisions
  float* d0;              // (B, 2N) demodulated symbols D0
  float* pw;              // (B, 2K) preamble DFT power |P @ F2|^2
  float* pre;             // (B, 4K) the link's preamble windows [re | im]
  const int* inv_demap;   // (N) payload index of each frame position, -1
                          // elsewhere; null: the last stage writes sym
  Act p_in;               // the preamble window P each burst's stages read
  Act f_in;               // the payload block F the estimate stage reads
  float* chan;            // (B, 2N) channel estimate, or null
  float* sym;             // (B, 2N) symbols, written whole (inv_demap null)
  float* q;               // (B, 2N) IC decisions (the receiver); null: f
};

// hi = tf32(x), lo = tf32(x - hi); x - hi is exact in float32
__device__ __forceinline__ float2 tf32_split(float x) {
  const float hi = wmma::__float_to_tf32(x);
  return make_float2(hi, wmma::__float_to_tf32(x - hi));
}

// 16 bytes global -> shared through L2; zero-filled (nothing read) where
// !valid.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Rows [row0, row0 + rows) x columns [k0, k0 + width) of both planes of a
// into dst [2][BM][ld]: 16-byte copies where the layout allows, else
// element loads; zeros past the rows or a.n.
template <int WIDTH>
__device__ __forceinline__ void load_rows(float* dst, int ld, const Act& a, int row0, int rows,
                                          int k0, bool vec) {
  if (vec) {
    constexpr int CH = WIDTH / 4;
    for (int i = threadIdx.x; i < 2 * BM * CH; i += THREADS) {
      const int q = i / (BM * CH), rem = i - q * BM * CH;
      const int r = rem / CH, c = rem - r * CH, k = k0 + 4 * c;
      const bool ok = r < rows && k < a.n;
      const float* src = ok ? a.p + static_cast<size_t>(row0 + r) * a.ld + q * a.im + k : a.p;
      cp16(dst + (q * BM + r) * ld + 4 * c, src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < 2 * BM * WIDTH; i += THREADS) {
      const int q = i / (BM * WIDTH), rem = i - q * BM * WIDTH;
      const int r = rem / WIDTH, c = rem - r * WIDTH, k = k0 + c;
      const bool ok = r < rows && k < a.n;
      dst[(q * BM + r) * ld + c] =
          ok ? a.p[static_cast<size_t>(row0 + r) * a.ld + q * a.im + k] : 0.f;
    }
  }
}

template <typename W>
__device__ __forceinline__ W zero() {
  if constexpr (sizeof(W) == 4) {
    return 0.f;
  } else {
    return __float2bfloat16_rn(0.f);
  }
}

// Operator slab: rows [k0, k0 + BK) of the three planes, columns
// [col0, col0 + BN), into sb [3][BK][LDB].
template <typename W>
__device__ __forceinline__ void load_op(W* sb, const W* g, int n_in, int n_out, int col0,
                                        int k0, bool vec) {
  const size_t plane = static_cast<size_t>(n_in) * n_out;
  if (vec) {
    constexpr int E = 16 / sizeof(W);  // elements a copy
    constexpr int CH = BN / E;
    for (int i = threadIdx.x; i < 3 * BK * CH; i += THREADS) {
      const int q = i / (BK * CH), rem = i - q * BK * CH;
      const int kr = rem / CH, c = rem - kr * CH;
      const int k = k0 + kr, col = col0 + E * c;
      const bool ok = k < n_in && col < n_out;
      const W* src = ok ? g + q * plane + static_cast<size_t>(k) * n_out + col : g;
      cp16(sb + (q * BK + kr) * LDB + E * c, src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < 3 * BK * BN; i += THREADS) {
      const int q = i / (BK * BN), rem = i - q * BK * BN;
      const int kr = rem / BN, c = rem - kr * BN;
      const int k = k0 + kr, col = col0 + c;
      const bool ok = k < n_in && col < n_out;
      sb[(q * BK + kr) * LDB + c] =
          ok ? g[q * plane + static_cast<size_t>(k) * n_out + col] : zero<W>();
    }
  }
}

// --- 3xTF32 (float32 stacks) ---
using TfA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
using TfB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
using TfC = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
// --- bf16 ---
using HA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using HB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using HC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <typename W>
struct Acc {
  using type = TfC;
};
template <>
struct Acc<bf16> {
  using type = HC;
};

// Fragments of one type share one element layout, so element-wise work on
// them (the sum plane, the split, the slab sums, yr / yi) is layout-free.
template <typename F>
__device__ __forceinline__ void split(const F& x, F& hi, F& lo) {
#pragma unroll
  for (int e = 0; e < x.num_elements; ++e) {
    const float2 s = tf32_split(x.x[e]);
    hi.x[e] = s.x;
    lo.x[e] = s.y;
  }
}

template <typename C>
__device__ __forceinline__ void zero_frags(C (&f)[FI][FJ]) {
#pragma unroll
  for (int i = 0; i < FI; ++i)
#pragma unroll
    for (int j = 0; j < FJ; ++j) wmma::fill_fragment(f[i][j], 0.f);
}

// acc += part, IEEE float32 adds. The tensor cores add into an accumulator
// fragment with truncation, so a sum carried over every slab of a long k
// drifts from the float32 product (1.3e-4 on the link's data at K = 256 on
// an H100, against ~5e-6 with this);
// each slab's sum starts from zero and joins the running sum here, which
// keeps the product at float32's error.
template <typename C>
__device__ __forceinline__ void promote(C (&acc)[FI][FJ], const C (&part)[FI][FJ]) {
#pragma unroll
  for (int i = 0; i < FI; ++i)
#pragma unroll
    for (int j = 0; j < FJ; ++j)
#pragma unroll
      for (int e = 0; e < acc[i][j].num_elements; ++e) acc[i][j].x[e] += part[i][j].x[e];
}

// One slab on tensor cores, 3xTF32: acc[q] += plane q of the activation
// (xr, xi, xr + xi) @ plane q of the operator.
__device__ __forceinline__ void mma_slab(const float* sa, const float* sb,
                                         TfC (&acc)[3][FI][FJ], int wm, int wn) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    TfC part[FI][FJ];
    zero_frags(part);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      TfA ah[FI], al[FI];
#pragma unroll
      for (int i = 0; i < FI; ++i) {
        const float* p = sa + (wm * WM + i * 16) * LDA + kk;
        TfA x;
        wmma::load_matrix_sync(x, p + (q == 1 ? BM * LDA : 0), LDA);
        if (q == 2) {
          TfA xi;
          wmma::load_matrix_sync(xi, p + BM * LDA, LDA);
#pragma unroll
          for (int e = 0; e < x.num_elements; ++e) x.x[e] += xi.x[e];
        }
        split(x, ah[i], al[i]);
      }
#pragma unroll
      for (int j = 0; j < FJ; ++j) {
        TfB y, bh, bl;
        wmma::load_matrix_sync(y, sb + (q * BK + kk) * LDB + wn * WN + j * 16, LDB);
        split(y, bh, bl);
#pragma unroll
        for (int i = 0; i < FI; ++i) {
          wmma::mma_sync(part[i][j], al[i], bh, part[i][j]);
          wmma::mma_sync(part[i][j], ah[i], bl, part[i][j]);
          wmma::mma_sync(part[i][j], ah[i], bh, part[i][j]);
        }
      }
    }
    promote(acc[q], part);
  }
}

// The slab's activation rounded to bf16 into sah [3][BM][LDAH]: xr, xi and
// their sum plane bf16(bf16(xr) + bf16(xi)).
__device__ __forceinline__ void round_act(const float* sa, bf16* sah) {
  for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
    const int r = i / BK, k = i - r * BK;
    const bf16 a = __float2bfloat16_rn(sa[r * LDA + k]);
    const bf16 c = __float2bfloat16_rn(sa[(BM + r) * LDA + k]);
    sah[r * LDAH + k] = a;
    sah[(BM + r) * LDAH + k] = c;
    sah[(2 * BM + r) * LDAH + k] = __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(c));
  }
}

// bf16: every k = 16 step's sum joins acc by IEEE adds, which keeps the
// float32 activations of the next stage close enough to the plain version's
// that few land on the other side of a bf16 rounding boundary.
__device__ __forceinline__ void mma_slab(const bf16* sah, const bf16* sb, HC (&acc)[3][FI][FJ],
                                         int wm, int wn) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      HC part[FI][FJ];
      zero_frags(part);
      HA a[FI];
#pragma unroll
      for (int i = 0; i < FI; ++i) {
        wmma::load_matrix_sync(a[i], sah + (q * BM + wm * WM + i * 16) * LDAH + kk, LDAH);
      }
#pragma unroll
      for (int j = 0; j < FJ; ++j) {
        HB b;
        wmma::load_matrix_sync(b, sb + (q * BK + kk) * LDB + wn * WN + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < FI; ++i) wmma::mma_sync(part[i][j], a[i], b, part[i][j]);
      }
      promote(acc[q], part);
    }
  }
}

// --- float64 sums (the bf16 link's stages whose output is rounded to bf16
// by the next one; the dense receiver's float32 stacks) ---
// d += a * b on the FP64 tensor cores: mma.m8n8k4, A row-major and B
// column-major. Lane l holds A[l / 4][l % 4], B[l % 4][l / 4] and
// C[l / 4][2 (l % 4) + i].
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

constexpr int DI = WM / 8, DJ = WN / 8;  // a warp's 8 x 8 tiles

__device__ __forceinline__ float op_value(bf16 w) { return __bfloat162float(w); }
__device__ __forceinline__ float op_value(float w) { return w; }

// One slab, float64 sums: the activation as the stack's type takes it (bf16:
// rounded to bf16 as round_act does, xr, xi and their bf16 sum plane;
// float32: as it is, the sum plane a float32 add), the operator exact in
// float64, so every product is exact and only the float64 sums round:
// acc[q] += plane q of the activation @ plane q of the operator.
template <typename W>
__device__ __forceinline__ void mma_slab_f64(const float* sa, const W* sb,
                                             double (&acc)[3][DI][DJ][2], int wm, int wn) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll 1  // the 96 accumulators leave no room for a second step's operands
  for (int kk = 0; kk < BK; kk += 4) {
    double xr[DI], xi[DI], xs[DI];
#pragma unroll
    for (int i = 0; i < DI; ++i) {
      const int r = wm * WM + i * 8 + g;
      if constexpr (sizeof(W) == 2) {
        const float a = bf16_round(sa[r * LDA + kk + t]);
        const float c = bf16_round(sa[(BM + r) * LDA + kk + t]);
        xr[i] = a;
        xi[i] = c;
        xs[i] = bf16_round(a + c);
      } else {
        const float a = sa[r * LDA + kk + t], c = sa[(BM + r) * LDA + kk + t];
        xr[i] = a;
        xi[i] = c;
        xs[i] = __fadd_rn(a, c);
      }
    }
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const W* b = sb + (kk + t) * LDB + wn * WN + j * 8 + g;
      const double w1 = op_value(b[0]);
      const double w2 = op_value(b[BK * LDB]);
      const double w3 = op_value(b[2 * BK * LDB]);
#pragma unroll
      for (int i = 0; i < DI; ++i) {
        dmma(acc[0][i][j], xr[i], w1);
        dmma(acc[1][i][j], xi[i], w2);
        dmma(acc[2][i][j], xs[i], w3);
      }
    }
  }
}

// The ring: slab t of the activation a and of the stack g lands in slot
// t % 2 while slab t - 1 is multiplied. slab(sa, sb) runs once a slab has
// landed, for every thread; all copies are complete on return.
template <typename W, typename Slab>
__device__ __forceinline__ void for_slabs(unsigned char* smem, const Act& a,
                                          const W* __restrict__ g, int n_out, int row0,
                                          int rows, int col0, Slab slab) {
  const int n_in = a.n;
  const bool a_vec = a.vec();
  const bool b_vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0 && n_out % (16 / sizeof(W)) == 0;
  auto slot_a = [&](int s) { return reinterpret_cast<float*>(smem + s * slot_bytes<W>()); };
  auto slot_b = [&](int s) {
    return reinterpret_cast<W*>(smem + s * slot_bytes<W>() + A_BYTES);
  };
  auto load = [&](int t) {
    load_rows<BK>(slot_a(t & 1), LDA, a, row0, rows, t * BK, a_vec);
    load_op<W>(slot_b(t & 1), g, n_in, n_out, col0, t * BK, b_vec);
    cp_commit();
  };
  const int nk = (n_in + BK - 1) / BK;
  load(0);
  for (int t = 0; t < nk; ++t) {
    // slab t has landed and every warp is done with slab t - 1's slot,
    // which now takes slab t + 1 while slab t is multiplied
    cp_wait_all();
    __syncthreads();
    if (t + 1 < nk) load(t + 1);
    slab(slot_a(t & 1), slot_b(t & 1));
  }
  __syncthreads();  // the caller's output may overlap the ring
}

// The tile [row0, row0 + rows) x [col0, col0 + BN) of the Gauss product of
// activation a with stack g (a.n = n_in rows a plane, n_out columns) into
// dst: yr at dst[r * LDO + c], yi at dst[(BM + r) * LDO + c]. Uses the ring
// at smem; dst may overlap it. The caller has finished with the ring and
// with dst (a barrier) and may have cp.async groups of its own in flight:
// they are complete on return, as is dst, for every thread. F64: float64
// sums on the FP64 tensor cores, rounded once to float32 (a bf16 stack's
// output that the next stage rounds to bf16; the dense receiver's float32
// stacks, whose IC decisions then match the plain version summed in
// float64).
template <typename W, bool F64 = false>
__device__ void gauss_tile(unsigned char* smem, const Act& a, const W* __restrict__ g,
                           int n_out, int row0, int rows, int col0, float* dst) {
  const int warp = threadIdx.x / 32, wm = warp / WARPS_N, wn = warp % WARPS_N;
  if constexpr (F64) {
    double acc[3][DI][DJ][2] = {};
    for_slabs<W>(smem, a, g, n_out, row0, rows, col0, [&](const float* sa, const W* sb) {
      mma_slab_f64(sa, sb, acc, wm, wn);
    });
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < DI; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = wm * WM + i * 8 + lane / 4, c = wn * WN + j * 8 + 2 * (lane % 4) + e;
          const double p1 = acc[0][i][j][e], p2 = acc[1][i][j][e];
          dst[r * LDO + c] = __double2float_rn(p1 - p2);
          dst[(BM + r) * LDO + c] = __double2float_rn(acc[2][i][j][e] - p1 - p2);
        }
  } else {
    using C = typename Acc<W>::type;
    C acc[3][FI][FJ];
#pragma unroll
    for (int q = 0; q < 3; ++q) zero_frags(acc[q]);
    for_slabs<W>(smem, a, g, n_out, row0, rows, col0, [&](const float* sa, const W* sb) {
      if constexpr (sizeof(W) == 2) {
        bf16* sah = reinterpret_cast<bf16*>(smem + 2 * slot_bytes<W>());
        round_act(sa, sah);
        __syncthreads();
        mma_slab(sah, sb, acc, wm, wn);
        __syncthreads();  // before the next slab's rounding overwrites sah
      } else {
        mma_slab(sa, sb, acc, wm, wn);
      }
    });
#pragma unroll
    for (int i = 0; i < FI; ++i)
#pragma unroll
      for (int j = 0; j < FJ; ++j) {
        C& p1 = acc[0][i][j];
        C& p2 = acc[1][i][j];
        const C& p3 = acc[2][i][j];
#pragma unroll
        for (int e = 0; e < p1.num_elements; ++e) {
          const float v1 = p1.x[e], v2 = p2.x[e];
          p1.x[e] = v1 - v2;
          p2.x[e] = p3.x[e] - v1 - v2;
        }
        float* o = dst + (wm * WM + i * 16) * LDO + wn * WN + j * 16;
        wmma::store_matrix_sync(o, p1, LDO, wmma::mem_row_major);
        wmma::store_matrix_sync(o + BM * LDO, p2, LDO, wmma::mem_row_major);
      }
  }
  __syncthreads();
}

}  // namespace lg
}  // namespace gfdm
