// The superseded GFDM receivers for Hopper (sm_90a). The production dense
// receiver (_rx_ic_circ_kernel, rx_receiver_fused) runs as staged
// tensor-core products in link.cu.
//
// Four Pallas kernels, one set of stages: each receiver is a short plan of
// launches of gfdm_rx_variant (kernels/fused.py _variant_plan):
//   kChanIn   frames, channel (B, 2N) given: dft_zf, demod, then cancel
//             where ic_iterations > 0 (_rx_core_kernel, rx_core_fused, no
//             IC; _rx_ic_kernel, rx_ic_fused, whose block-diagonal (N, N) C
//             pair is the same circulant);
//   kEstimate bursts: estimate, then as kChanIn (_rx_full_kernel,
//             rx_full_fused, whose realified (2M, 2M) C_W is the same
//             circulant);
//   kHybrid   estimate (the channel written out), dft_zf, then one
//             per-burst pass of the L-tap fold, the per-subcarrier M-point
//             IDFTs and the IC in place of the Bfd product
//             (_rx_hybrid_kernel, rx_receiver_hybrid).
// None of the variants writes metrics. Their IC reads the (2, M) taps, the
// QPSK amplitude folded in, where the Pallas kernels multiply by the
// block-diagonal or realified operator (convert.py checks both against the
// taps).
//
// Bound (H100 SXM): 2.21 M fp32 MACs a burst without IC (the 2K-deep
// estimate, the N-point DFT and the Bfd demodulator, three Gauss products
// each; 1.99 M with the channel given), plus 0.02 M an IC iteration; the
// hybrid drops the 1.0 M-MAC Bfd product for N (L + M) complex MACs. At B =
// 65,536 and the canonical config rx_core is 2.61e11 operations, 3.894 ms at
// the 67 TFLOP/s of fp32 FMA, against 6 KB a burst of bytes: FMA-bound.
//
// Design: every product is gauss_gemm_kernel, a register-blocked Gauss GEMM
// over (bursts x output columns) tiles of 64 x 64 (BM x BN), 128 threads and
// three CTAs an SM, column tile fastest (the CTAs in flight share their A
// rows in L2; each operator tile leaves L2 once a 64-burst tile). k runs in
// BK = 16-deep k-tiles through a two-slot cp.async ring: a slot holds the A
// operand's (64 x 16) slabs of both planes [row][k] and the three Gauss
// planes' (16 x 64) slabs [k][col]. A is read in place through a window
// (Win: the preamble at cp and the payload at preamble_len + cp of each
// burst row, pitch 2 frame_len; the frames (B, 2N) for kChanIn; Y for the
// demodulator). Copies are 16 bytes where every base, pitch and plane
// offset allows, else 4; rows past B, k past the depth and columns past N
// are zero-filled by the copy's src-size. Each A slab is transposed once in
// shared memory to [k][row], so a thread reads its 8 rows of one k as two
// 16-byte loads a plane; with its 4 columns of the three planes, 7 shared
// loads and 8 adds (s = xr + xi) feed 96 FMAs, the three products' sums
// p1 = xr Wr, p2 = xi Wi, p3 = s (Wr + Wi) in registers. Every sum is one
// FMA chain over k in order from zero, no split-k, no TF32, as cuBLAS's
// SGEMM sums the plain version's products; the epilogue combines (p1 - p2,
// (p3 - p1) - p2) and, in the DFT stage, divides by the channel at the same
// (row, column) (ZF, |C|^2 clamped at 1e-30), each operation rounded as the
// plain version's torch ops round it. The intermediates chan, Y and D0 are
// (B, 2N) rows in device memory (0.18 ms each way at B = 65,536).
// burst_kernel takes one burst a CTA with its N-wide rows and the small
// tables in shared memory (burst_smem_floats: 6N + 2M floats, the hybrid's
// IDFT and filter parts besides): every IC iteration in one launch, the
// decisions, their k +- 1 neighbour sums once an iteration, then the M-tap
// circulant; for the hybrid first the fold and the IDFTs of Y.
#include "fma_gemm.cuh"  // fg:: the cp.async copies
#include "gfdm_common.cuh"

namespace gfdm {
namespace rxv {

enum Variant { kChanIn = 0, kEstimate = 1, kHybrid = 2 };
// a launch of a variant's plan (kernels/fused.py _VARIANT_STAGES)
enum Stage { kEst = 0, kDftZf = 1, kDemod = 2, kCancel = 3, kHybridPass = 4 };

constexpr int BM = 64, BN = 64, BK = 16, STAGES = 2, THREADS = 128;
constexpr int TM = 8, TN = 4;     // a thread's block: rows 8 ty + i, columns 4 tx + j
constexpr int TXN = BN / TN;      // 16 column groups
static_assert(BM == (THREADS / TXN) * TM && BK == 16 && TM == 8 && TN == 4,
              "the slab's swizzle, the transpose and the float4 operands");
constexpr int A_FLOATS = BM * BK;  // one A plane's slab (and its transpose)
constexpr int W_FLOATS = BK * BN;  // one Gauss plane's slab
constexpr int SLOT = 2 * A_FLOATS + 3 * W_FLOATS;
// the ring, then the A slab's two planes transposed to [k][row]
constexpr size_t GEMM_SMEM = sizeof(float) * (STAGES * SLOT + 2 * A_FLOATS);
constexpr int BURST_THREADS = 256;  // a burst_kernel CTA's threads, at most

// A stage's A operand: row r, plane q (0 re, 1 im), k < n at p[r ld + q im + k].
struct Win {
  const float* p;
  int ld, im, n;
};

// A slab element (row r, k): its 16-byte k-chunk XOR-ed by (r / 2) % 4, so
// that the transpose's 16-byte reads of 8 consecutive rows fall in 8
// different bank groups.
__device__ __forceinline__ int a_at(int r, int k) {
  return r * BK + (((k >> 2) ^ ((r >> 1) & 3)) << 2) + (k & 3);
}

template <int VEC>
__device__ __forceinline__ void copy(float* dst, const float* src, bool ok) {
  if constexpr (VEC == 4) {
    fg::cp_async16_zfill(dst, src, ok);
  } else {
    fg::cp_async4_zfill(dst, src, ok);
  }
}

// k-tile k0 into a ring slot: A rows row0 .. row0 + 64 (both planes) and
// the Gauss stack's rows k0 .. k0 + 16 of each plane, columns col0 ..
// col0 + 64. The depth a.n and n_out are multiples of VEC, so a copy is
// wholly in or out.
template <int VEC>
__device__ __forceinline__ void load_slot(float* slot, const Win& a, const float* g,
                                          int n_out, int row0, int nb, int col0, int k0,
                                          int tid) {
  constexpr int AC = BK / VEC;  // copies an A row of the slab
#pragma unroll
  for (int i = 0; i < 2 * A_FLOATS / VEC / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int q = c / (A_FLOATS / VEC), rem = c - q * (A_FLOATS / VEC);
    const int r = rem / AC, kk = (rem - r * AC) * VEC, k = k0 + kk;
    const bool ok = r < nb && k < a.n;
    const float* src = ok ? a.p + static_cast<size_t>(row0 + r) * a.ld + q * a.im + k : a.p;
    copy<VEC>(slot + q * A_FLOATS + a_at(r, kk), src, ok);
  }
  constexpr int WC = BN / VEC;  // copies a Gauss row of the slab
  float* ws = slot + 2 * A_FLOATS;
#pragma unroll
  for (int i = 0; i < 3 * W_FLOATS / VEC / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int q = c / (W_FLOATS / VEC), rem = c - q * (W_FLOATS / VEC);
    const int r = rem / WC, cc = (rem - r * WC) * VEC;
    const int k = k0 + r, col = col0 + cc;
    const bool ok = k < a.n && col < n_out;
    const float* src = ok ? g + (static_cast<size_t>(q) * a.n + k) * n_out + col : g;
    copy<VEC>(ws + q * W_FLOATS + r * BN + cc, src, ok);
  }
}

// ZF divide of x by the channel h, each operation rounded as the plain
// version's (_zf): den = max(hr hr + hi hi, 1e-30).
__device__ __forceinline__ void zf(float& xr, float& xi, float hr, float hi) {
  const float den = fmaxf(__fadd_rn(__fmul_rn(hr, hr), __fmul_rn(hi, hi)), 1e-30f);
  const float yr = __fdiv_rn(__fadd_rn(__fmul_rn(xr, hr), __fmul_rn(xi, hi)), den);
  const float yi = __fdiv_rn(__fsub_rn(__fmul_rn(xi, hr), __fmul_rn(xr, hi)), den);
  xr = yr;
  xi = yi;
}

// out (batch, 2 n_out) = the complex product of A's rows with the Gauss
// stack g (3 a.n, n_out); with ZF divided by chan (batch, 2 n_out).
template <int VEC, bool ZF>
__global__ void __launch_bounds__(THREADS, 3)
gauss_gemm_kernel(int batch, int n_out, Win a, const float* __restrict__ g,
                  const float* __restrict__ chan, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* tr = smem + STAGES * SLOT;  // [k][row] planes xr, xi
  const int tid = threadIdx.x, tx = tid % TXN, ty = tid / TXN;
  const int n_ct = (n_out + BN - 1) / BN;
  const int row0 = (blockIdx.x / n_ct) * BM, col0 = (blockIdx.x % n_ct) * BN;
  const int nb = min(BM, batch - row0);
  const int nt = (a.n + BK - 1) / BK;

  float p1[TM][TN], p2[TM][TN], p3[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) p1[i][j] = p2[i][j] = p3[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) load_slot<VEC>(smem + s * SLOT, a, g, n_out, row0, nb, col0, s * BK, tid);
    fg::cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    fg::cp_async_wait<STAGES - 2>();  // k-tile t has landed
    __syncthreads();  // ... for every thread; k-tile t - 1's slot and the transpose are free
    // k-tile t + 1 into the other slot while t is transposed and multiplied
    const int tn = t + STAGES - 1;
    if (tn < nt) {
      load_slot<VEC>(smem + (tn % STAGES) * SLOT, a, g, n_out, row0, nb, col0, tn * BK, tid);
    }
    fg::cp_async_commit();
    const float* slot = smem + (t % STAGES) * SLOT;
    {  // transpose: row r, k 8 h .. 8 h + 7 of xr and xi
      const int r = tid % BM, h = tid / BM;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int at = a_at(r, 8 * h + 4 * u);
        const float4 x = *reinterpret_cast<const float4*>(slot + at);
        const float4 y = *reinterpret_cast<const float4*>(slot + A_FLOATS + at);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* col = tr + (8 * h + 4 * u + e) * BM + r;
          col[0] = fg::lane4(x, e);
          col[A_FLOATS] = fg::lane4(y, e);
        }
      }
    }
    __syncthreads();
    const float* w = slot + 2 * A_FLOATS;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      // rows 8 ty .. 8 ty + 7 of k: a warp reads two 32-byte runs, broadcast
      const float4* xk = reinterpret_cast<const float4*>(tr + k * BM + TM * ty);
      const float4 xr[2] = {xk[0], xk[1]};
      const float4 xi[2] = {xk[A_FLOATS / 4], xk[A_FLOATS / 4 + 1]};
      const float* wk = w + k * BN + TN * tx;
      const float4 w1 = *reinterpret_cast<const float4*>(wk);
      const float4 w2 = *reinterpret_cast<const float4*>(wk + W_FLOATS);
      const float4 w3 = *reinterpret_cast<const float4*>(wk + 2 * W_FLOATS);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float ar = fg::lane4(xr[i / 4], i % 4), ai = fg::lane4(xi[i / 4], i % 4);
        const float as = ar + ai;
#pragma unroll
        for (int j = 0; j < TN; ++j) p1[i][j] = fmaf(ar, fg::lane4(w1, j), p1[i][j]);
#pragma unroll
        for (int j = 0; j < TN; ++j) p2[i][j] = fmaf(ai, fg::lane4(w2, j), p2[i][j]);
#pragma unroll
        for (int j = 0; j < TN; ++j) p3[i][j] = fmaf(as, fg::lane4(w3, j), p3[i][j]);
      }
    }
  }
  fg::cp_async_wait<0>();

  // the epilogue: a thread's 8 rows x 4 columns of both planes
  const size_t ldo = 2 * static_cast<size_t>(n_out);
  const int c0 = col0 + TN * tx;
  if (c0 >= n_out) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = TM * ty + i;
    if (r >= nb) break;
    float yr[TN], yi[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      yr[j] = p1[i][j] - p2[i][j];
      yi[j] = (p3[i][j] - p1[i][j]) - p2[i][j];
    }
    const size_t o = static_cast<size_t>(row0 + r) * ldo + c0;
    if constexpr (VEC == 4) {  // n_out % 4 == 0: the 4 columns are all in
      if constexpr (ZF) {
        const float4 hr = *reinterpret_cast<const float4*>(chan + o);
        const float4 hi = *reinterpret_cast<const float4*>(chan + o + n_out);
#pragma unroll
        for (int j = 0; j < TN; ++j) zf(yr[j], yi[j], fg::lane4(hr, j), fg::lane4(hi, j));
      }
      *reinterpret_cast<float4*>(out + o) = make_float4(yr[0], yr[1], yr[2], yr[3]);
      *reinterpret_cast<float4*>(out + o + n_out) = make_float4(yi[0], yi[1], yi[2], yi[3]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (c0 + j >= n_out) break;
        if constexpr (ZF) zf(yr[j], yi[j], chan[o + j], chan[o + n_out + j]);
        out[o + j] = yr[j];
        out[o + n_out + j] = yi[j];
      }
    }
  }
}

// Shared-memory floats of burst_kernel: D0, the decisions Q and the
// neighbour sums NS (2N each), the IC taps (2M) and, for the hybrid, the
// realified M-point IDFT (2M x 2M) and the receive filter parts (L x 2 x M).
inline int burst_smem_floats(const Dims& d, bool hybrid) {
  const int M = d.timeslots;
  return 6 * d.n + 2 * M + (hybrid ? 4 * M * M + 2 * d.overlap * M : 0);
}

// One burst a CTA: its D0 (hybrid: the fold and the M-point IDFTs of its Y)
// in shared memory, then ic_iterations of Q = decisions of D (the first on
// D0) on the active symbols -> NS = Q of subcarrier k - 1 + Q of k + 1
// (mod K) -> the interference, the M-tap circulant of NS within the
// M-block (tap j multiplies timeslot (m - j) mod M) -> D = D0 -
// interference, into sym. Each operation is rounded as the plain version's
// torch ops round it (_fold_rx's pmul and sum, _conv_ic, _cancel_plain);
// the IDFT is one FMA chain over the realified (2M, 2M) operator's rows.
template <bool HYBRID>
__global__ void __launch_bounds__(BURST_THREADS)
burst_kernel(Dims d, Consts c, const float* __restrict__ in, float* __restrict__ sym) {
  extern __shared__ __align__(16) float smem[];
  const int n = d.n, w = 2 * n, M = d.timeslots, K = d.subcarriers, L = d.overlap;
  float* d0 = smem;
  float* q = d0 + w;
  float* ns = q + w;
  float* tap = ns + w;        // tr[j] = tap[j], ti[j] = tap[M + j]
  float* ifm = tap + 2 * M;   // hybrid: iFM_W, then the parts
  float* parts = ifm + 4 * M * M;
  const float* src = in + static_cast<size_t>(blockIdx.x) * w;
  float* dst = sym + static_cast<size_t>(blockIdx.x) * w;
  for (int i = threadIdx.x; i < 2 * M; i += blockDim.x) tap[i] = __ldg(c.taps + i);
  if constexpr (HYBRID) {
    float* y = ns;
    float* s = q;
    for (int i = threadIdx.x; i < 4 * M * M; i += blockDim.x) ifm[i] = __ldg(c.ifm + i);
    for (int i = threadIdx.x; i < 2 * L * M; i += blockDim.x) parts[i] = __ldg(c.parts + i);
    for (int i = threadIdx.x; i < w; i += blockDim.x) y[i] = src[i];
    __syncthreads();
    // the fold: S[k M + m] = sum_l Y[((k + l - L/2) mod K) M + m] parts[(l + L/2) % L][m]
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int k = i / M, m = i - k * M;
      float sr = 0.f, si = 0.f;
      for (int l = 0; l < L; ++l) {
        int kk = k + l - L / 2;
        kk = kk < 0 ? kk + K : (kk >= K ? kk - K : kk);
        const float xr = y[kk * M + m], xi = y[n + kk * M + m];
        const float* p = parts + ((l + L / 2) % L) * 2 * M;
        const float pr = p[m], pi = p[M + m];
        sr = __fadd_rn(sr, __fsub_rn(__fmul_rn(xr, pr), __fmul_rn(xi, pi)));
        si = __fadd_rn(si, __fadd_rn(__fmul_rn(xr, pi), __fmul_rn(xi, pr)));
      }
      s[i] = sr;
      s[n + i] = si;
    }
    __syncthreads();
    // the IDFTs: [d0r | d0i] of subcarrier k = [sr | si] @ iFM_W (2M, 2M)
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int m = i % M;
      const float* sr = s + (i - m);
      const float* e = ifm + m;
      float xr = 0.f, xi = 0.f;
      for (int t = 0; t < M; ++t, e += 2 * M) {
        xr = fmaf(sr[t], e[0], xr);
        xi = fmaf(sr[t], e[M], xi);
      }
      for (int t = 0; t < M; ++t, e += 2 * M) {
        xr = fmaf(sr[n + t], e[0], xr);
        xi = fmaf(sr[n + t], e[M], xi);
      }
      d0[i] = xr;
      d0[n + i] = xi;
    }
  } else {
    for (int i = threadIdx.x; i < w; i += blockDim.x) d0[i] = src[i];
  }
  __syncthreads();
  if (d.ic_iterations == 0) {
    for (int i = threadIdx.x; i < w; i += blockDim.x) dst[i] = d0[i];
    return;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float a = __ldg(c.act + i);
    q[i] = ic_level(d0[i], d.dec_kind) * a;
    q[n + i] = ic_level(d0[n + i], d.dec_kind) * a;
  }
  for (int it = 0; it < d.ic_iterations; ++it) {
    __syncthreads();  // Q is whole
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int k = i / M, m = i - k * M;
      const int lo = (k == 0 ? K - 1 : k - 1) * M + m, hi = (k == K - 1 ? 0 : k + 1) * M + m;
      ns[i] = __fadd_rn(q[lo], q[hi]);
      ns[n + i] = __fadd_rn(q[n + lo], q[n + hi]);
    }
    __syncthreads();  // NS is whole; Q is free
    const bool last = it + 1 == d.ic_iterations;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int m = i % M;
      const float* nr = ns + (i - m);
      float ir = 0.f, ii = 0.f;
      for (int j = 0, mm = m; j < M; ++j, mm = mm == 0 ? M - 1 : mm - 1) {
        const float sr = nr[mm], si = nr[n + mm];
        const float tr = tap[j], ti = tap[M + j];
        ir = __fsub_rn(__fadd_rn(ir, __fmul_rn(tr, sr)), __fmul_rn(ti, si));
        ii = __fadd_rn(__fadd_rn(ii, __fmul_rn(tr, si)), __fmul_rn(ti, sr));
      }
      const float dr = __fsub_rn(d0[i], ir), di = __fsub_rn(d0[n + i], ii);
      if (last) {
        dst[i] = dr;
        dst[n + i] = di;
      } else {
        const float a = __ldg(c.act + i);
        q[i] = ic_level(dr, d.dec_kind) * a;
        q[n + i] = ic_level(di, d.dec_kind) * a;
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int VEC, bool ZF>
int run_gemm(int batch, int n_out, const Win& a, const float* g, const float* chan, float* out,
             cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      gauss_gemm_kernel<VEC, ZF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(GEMM_SMEM));
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // a refused launch leaves no error behind
    return static_cast<int>(err);
  }
  const int tiles = ((n_out + BN - 1) / BN) * ((batch + BM - 1) / BM);
  gauss_gemm_kernel<VEC, ZF><<<tiles, THREADS, GEMM_SMEM, stream>>>(batch, n_out, a, g, chan,
                                                                   out);
  return static_cast<int>(cudaGetLastError());
}

// The widest copy every operand's base, pitch, plane offset and width allow.
template <bool ZF>
int launch_gemm(int batch, int n_out, const Win& a, const void* g, const float* chan,
                float* out, cudaStream_t stream) {
  const float* gf = static_cast<const float*>(g);
  const bool v4 = aligned16(a.p) && a.ld % 4 == 0 && a.im % 4 == 0 && a.n % 4 == 0 &&
                  n_out % 4 == 0 && aligned16(gf) && aligned16(out) &&
                  (!ZF || aligned16(chan));
  if (v4) return run_gemm<4, ZF>(batch, n_out, a, gf, chan, out, stream);
  return run_gemm<1, ZF>(batch, n_out, a, gf, chan, out, stream);
}

template <bool HYBRID>
int launch_burst(const Dims& d, const Consts& c, const float* in, float* sym,
                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * burst_smem_floats(d, HYBRID);
  const cudaError_t err = cudaFuncSetAttribute(
      burst_kernel<HYBRID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // a refused launch leaves no error behind
    return static_cast<int>(err);
  }
  // the fewest rounds of at most BURST_THREADS over the N columns, each
  // round as full as a multiple of 32 threads allows (576: 3 x 192)
  const int rounds = (d.n + BURST_THREADS - 1) / BURST_THREADS;
  const int threads = ((d.n + rounds - 1) / rounds + 31) / 32 * 32;
  burst_kernel<HYBRID><<<d.batch, threads, smem, stream>>>(d, c, in, sym);
  return static_cast<int>(cudaGetLastError());
}

// One burst's state in the one-kernel receivers these stages replaced: the
// preamble window and four planar N-wide rows, (4K + 8N) floats. The
// variants take the configs whose state fits a CTA's opt-in shared memory,
// as those did (K <= 512 at M = 9); the stages themselves need about 6N
// floats a burst (burst_smem_floats), and a larger N is the factored
// receiver's.
inline size_t state_bytes(const Dims& d) {
  return sizeof(float) * (2 * static_cast<size_t>(d.half) + 8 * static_cast<size_t>(d.n));
}

inline bool state_fits(const Dims& d) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess) {
    return false;
  }
  return state_bytes(d) <= static_cast<size_t>(optin);
}

}  // namespace rxv
}  // namespace gfdm

// One launch of `stage` (gfdm::rxv::Stage) of receiver `variant`
// (gfdm::rxv::Variant) on `stream`. in: frames (B, 2N) for kChanIn, else
// bursts (B, 2 frame_len), read in place; chan (B, 2N): read (kChanIn) or
// written by the estimate; y, d0 (B, 2N) intermediates (d0 may be sym when
// no IC follows the demodulator); sym (B, 2N) the symbols. Returns 0, a
// CUDA error, or -1 for a stage the variant does not run.
extern "C" int gfdm_rx_variant(const gfdm::Dims* d, const gfdm::Consts* c, const float* in,
                               float* chan, float* y, float* d0, float* sym, int variant,
                               int stage, void* stream) {
  using namespace gfdm::rxv;
  if (d->batch <= 0) return 0;
  if (variant < kChanIn || variant > kHybrid) return -1;
  (void)cudaGetLastError();  // report this launch's error only (earlier calls reported theirs)
  if (!state_fits(*d)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int B = d->batch, n = d->n, L = d->frame_len;
  const Win frame = variant == kChanIn
                        ? Win{in, 2 * n, n, n}
                        : Win{in + d->preamble_len + d->cp_len, 2 * L, L, n};
  switch (stage) {
    case kEst:
      if (variant == kChanIn) return -1;
      return launch_gemm<false>(B, n, Win{in + d->cp_len, 2 * L, L, d->half}, c->e_g, nullptr,
                                chan, st);
    case kDftZf:
      return launch_gemm<true>(B, n, frame, c->f_g, chan, y, st);
    case kDemod:
      if (variant == kHybrid) return -1;
      return launch_gemm<false>(B, n, Win{y, 2 * n, n, n}, c->bfd_g, nullptr, d0, st);
    case kCancel:
      if (variant == kHybrid) return -1;
      return launch_burst<false>(*d, *c, d0, sym, st);
    case kHybridPass:
      if (variant != kHybrid) return -1;
      return launch_burst<true>(*d, *c, y, sym, st);
    default:
      return -1;
  }
}

// One burst's state that bounds the configs the superseded receivers take
// (gfdm::rxv::state_bytes), in bytes.
extern "C" size_t gfdm_rx_smem_bytes(const gfdm::Dims* d) { return gfdm::rxv::state_bytes(*d); }
