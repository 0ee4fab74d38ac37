// Factored GFDM kernels for Hopper (sm_90a): the large-K transmitter and
// receiver, with no dense operator of any kind on the demodulation path.
//
// Replaces the Pallas kernels gfdm_tpu/kernels/fused.py::_tx_factored_kernel
// (wrapper tx_frame_factored), ::_rx_factored_kernel (rx_receiver_factored,
// estimator="fused") and ::_rx_factored_chan_kernel (estimator="fast"). The
// receiver is one kernel that reads its channel; with estimator="fused" the
// channel comes from rx_estimate_kernel just before it, so the two
// receivers cannot drift apart.
//
// Receiver, per burst (N = K M; payload sample t = M n2 + n1):
//   Z[n1, k2]    = sum_n2 x[M n2 + n1] W_K^(n2 k2)                K-point DFTs
//   X[k1 K + k2] = sum_n1 FM[n1, k1] tw[n1, k2] Z[n1, k2]         M-point stage
//   Y            = X conj(H) / max(|H|^2, 1e-30)                  ZF
//   S[k M + m]   = sum_i parts[(i + L/2) % L][m] Y[((k + i - L/2) mod K) M + m]
//   d0[k M + m]  = sum_n iFM[n, m] S[k M + n]                     M-point IFFTs
//   d            = d0 - sum_j taps[j] (q[k-1, m-j] + q[k+1, m-j])   (ic_iterations)
// with q = +-1 (>= 0 -> +1) on active symbols and 0 elsewhere; H is read.
// The transmitter runs the same stages reversed: resource map, per-subcarrier
// M-point DFTs, L-tap overlap-add, the M-point stage of the N-point IDFT with
// the conjugate twiddles, K-point IDFTs; then CP/CS at the cyclic shift,
// window and preamble.
//
// The channel estimate of estimator="fused" (the Pallas kernel's
// chan = pre @ E over its block of bursts): H (B, 2N) = A (B, 4K) @ E_W
// (4K, 2N), row b of A the preamble window [bursts[b, 0, cp : cp + 2K] |
// bursts[b, 1, cp : cp + 2K]], read in place (two segments a row, no gather
// copy); H's rows are chan's (B, 2, N) rows [H_re | H_im]. Bound: its 2 B 4K
// 2N operations, 9.66 GFLOP at K = 128, B = 4,096: 0.144 ms at the 67
// TFLOP/s of fp32 FMA (the bytes, 47 MB, 0.014 ms). Design: fma_gemm.cuh's
// register-blocked GEMM over 64-burst x 128-column tiles, so each E_W tile
// that a CTA stages in shared memory serves 64 bursts (a CTA a burst would
// stream all of E_W from L2 for each burst: 19.3 GB at B = 4,096); 16-byte
// copies of A where cp_len, frame_len
// and 2K are multiples of 4 and of E_W and H where 2N is, 4-byte ones
// otherwise (chosen at launch); rows past B, columns past 2N and k past 4K
// zero-filled by the copies and not stored. Each output is one FMA chain
// over k in order (the re rows, then the im rows), from zero.
//
// The K-point stage. The Pallas kernel multiplies by a dense (2K, 2K) matrix
// (cheap on the MXU); on CUDA cores that is 8 M K^2 flops a burst (18.9 M at
// K = 512). For K a power of two the kernels run an in-place
// decimation-in-time FFT over the M rows instead, 5 M K log2 K flops (91x
// less at K = 512): radix-8 passes, the odd last one radix 2 or 4
// (fac_radix; a card test holds tests/factored_fft_emulation.py's plan
// against gfdm_factored_plan). The producer writes element t of a row at the
// bit reversal of t, so each pass reads a butterfly's R points at stride s in
// the radix's bit-reversed order, twiddles them, runs the R-point DFT in
// registers and writes the outputs back in natural order to the same words:
// one shared-memory read and write a point a pass, one barrier a pass, and
// the consumer reads element k at its natural place. Rows are padded
// (fac_pos: a gap after every 16 elements; fac_stride: rows start on
// different banks), so the first pass's 8 contiguous points, the others'
// strided ones and the M-point stages' column walks hit distinct banks. The
// twiddles are the K-entry table of row 1 of the realified K-point operator
// (the table the direct DFT reads), laid out pass by pass as [q - 1][j], so
// neighbouring threads read neighbouring words; the Tx's table carries the
// 1/K of the inverse DFT, so it is taken times K (exact for K a power of two)
// and the core is scaled by 1/K once, in the framing. tests/
// factored_fft_emulation.py replays this schedule on the CPU. Any other K
// runs the direct DFT (dft_rows), a second path of the same kernels.
//
// Bound: with the FFT, the bursts' bytes (read once, written once; the Tx
// 315 MB and the receiver with its channel read 499 MB at K = 512, B = 4,096);
// in practice the latency of each CTA's short stages between barriers. Design:
// one CTA a burst, 512 threads at most 64 registers (at K <= FAC_SMALL_K the
// receiver 128 threads, eight CTAs an SM: most of its stages run one thread a
// subcarrier); two stages of M padded rows, the twiddle table and the M-point
// operators, filter parts and IC taps in shared memory (84 KB at K = 512), so
// two CTAs share an SM at K <= 512.
// The burst's payload (scattered to its rows) and, with the FFT, the channel
// (planar, into the other stage) arrive by cp.async while the tables are
// built; the FFT runs in place; ZF writes Y over H; the M-point stages
// ping-pong between the two stages; the IC keeps its decisions as bytes in
// the stage the IFFTs freed, d0's taken in a pass of their own.
// With M = 9 (MT, a template parameter; any other M runs the same stages one
// thread a symbol) one thread a subcarrier keeps its column in registers
// through the M-point stages, the fold and the IC. Bursts and channels are
// read, and symbols and bursts written, 16 bytes a copy where the planes'
// offsets allow (VEC = 4, chosen at launch).
#include "fma_gemm.cuh"      // fg:: the estimator GEMM's body
#include "gfdm_common.cuh"  // cmla, op_entry, planar_at

namespace gfdm {

constexpr int FAC_MAX_THREADS = 512;  // two CTAs an SM: at most 64 registers
// The receiver at K <= FAC_SMALL_K: 128 threads a CTA, eight CTAs an SM, at
// most 64 registers.
constexpr int FAC_SMALL_K = 128;
constexpr int FAC_SMALL_THREADS = 128;
constexpr int FAC_ROWS = 3;  // DFT rows a thread accumulates (M = 9: 3 x 3)

// Sizes of one call. Field order mirrors kernels/cuda_lib.py::FactoredDims.
struct FactoredDims {
  int batch;          // B, any value >= 0 (one CTA a burst)
  int n;              // N = M * K
  int timeslots;      // M
  int subcarriers;    // K
  int overlap;        // L filter parts
  int n_data;         // payload symbols a burst
  int frame_len;      // burst length per plane
  int preamble_len;
  int cp_len;
  int shift;          // cyclic shift of the Tx
  int ic_iterations;
};

// Device pointers. Field order mirrors kernels/cuda_lib.py::FactoredConsts.
struct FactoredConsts {
  const float* fk;      // (2K, 2K) realified K-point DFT (receiver) / IDFT (Tx)
  const float* tw;      // (M, 2, K) twiddles exp(-+2 pi i n1 k2 / N)
  const float* fm;      // (2M, 2M) realified M-point DFT
  const float* ifm;     // (2M, 2M) realified M-point IDFT
  const float* parts;   // (L, 2, M) receive / transmit filter parts
  const float* taps;    // (2, M) circulant IC taps, QPSK amplitude folded in
  const float* act;     // (N) 1 on active subcarriers' symbols, else 0
  const int* map_idx;   // (N) payload index of each grid position, n_data: 0
  const float* win;     // (N + cp + cs) CP/CS window
  const float* pre;     // (2, preamble_len) preamble of this shift
};

// The K-point stage's plan: an FFT for K a power of two, else the direct DFT.
__host__ __device__ inline bool fac_fft(int K) { return K >= 2 && (K & (K - 1)) == 0; }

__host__ __device__ inline int fac_log2(int K) {
  int b = 0;
  while ((1 << b) < K) ++b;
  return b;
}

__host__ __device__ inline int fac_passes(int K) {
  return fac_fft(K) ? (fac_log2(K) + 2) / 3 : 0;
}

// radix of pass p: 8, the odd last pass 2 or 4
__host__ __device__ inline int fac_radix(int K, int p) {
  const int bits = fac_log2(K);
  return p < bits / 3 ? 8 : 1 << (bits % 3);
}

// Row layout: element i of a row at fac_pos(i); rows fac_stride(K) apart.
__host__ __device__ inline int fac_stride(int K) { return K + K / 16 + 1; }
__host__ __device__ __forceinline__ int fac_pos(int i) { return i + (i >> 4); }

// x rounded up to even: shared-memory regions start on 16 bytes
__host__ __device__ inline int fac_even(int x) { return (x + 1) & ~1; }

// A stage: the M padded rows of a burst (flat, N complex values, when a
// stage holds the burst in natural order)
__host__ __device__ inline int fac_stage(int K, int M) { return fac_even(M * fac_stride(K)); }

// The M-point operators, filter parts and IC taps staged in shared memory
// (complex): FM (M x M), iFM (M x M), parts (L x M), taps (M).
__host__ __device__ inline int fac_consts_len(int M, int L) { return 2 * M * M + L * M + M; }

// Shared memory of one CTA (the Tx's and the receiver's): the twiddle table
// (K), two stages of M padded rows and the small constants.
__host__ __device__ inline size_t factored_smem_bytes(const FactoredDims& d) {
  const size_t K = d.subcarriers;
  const size_t c = fac_even(K) + 2 * static_cast<size_t>(fac_stage(K, d.timeslots)) +
                   fac_consts_len(d.timeslots, d.overlap);
  return c * sizeof(float2);
}

inline bool fac_small(const FactoredDims& d) { return d.subcarriers <= FAC_SMALL_K; }

// Threads of a CTA: one per (row group, DFT bin) of the direct K-point stage.
inline int factored_threads(const FactoredDims& d) {
  const int groups = (d.timeslots + FAC_ROWS - 1) / FAC_ROWS;
  int t = (groups * d.subcarriers + 31) / 32 * 32;
  if (t < 64) t = 64;
  return t > FAC_MAX_THREADS ? FAC_MAX_THREADS : t;
}

// The twiddle table from row 1 of the realified K-point operator, times
// `scale`: for the FFT each pass's slice [q - 1][j] = W^(j q K / Ls), q < R,
// j < s = Ls / R (K - 1 entries in all); for the direct DFT W^t, t < K.
__device__ __forceinline__ void fac_twiddles(float2* wk, const float* fk, int K,
                                             float scale) {
  if (!fac_fft(K)) {
    for (int t = threadIdx.x; t < K; t += blockDim.x) wk[t] = op_entry(fk, K, 1, t);
    return;
  }
  int off = 0, ls = 1;
  for (int p = 0; p < fac_passes(K); ++p) {
    const int r = fac_radix(K, p), s = ls;
    ls *= r;
    const int step = K / ls;
    for (int t = threadIdx.x; t < (r - 1) * s; t += blockDim.x) {
      const int q = t / s + 1, j = t - (q - 1) * s;
      const float2 w = op_entry(fk, K, 1, j * q * step);
      wk[off + t] = make_float2(w.x * scale, w.y * scale);
    }
    off += (r - 1) * s;
  }
}

// The small constants into `cs` (fac_consts_len): a warp then reads each
// entry as one broadcast word.
__device__ __forceinline__ void fac_consts(float2* cs, const FactoredConsts& c, int M,
                                           int L) {
  for (int t = threadIdx.x; t < M * M; t += blockDim.x) {
    cs[t] = op_entry(c.fm, M, t / M, t % M);
    cs[M * M + t] = op_entry(c.ifm, M, t / M, t % M);
  }
  for (int t = threadIdx.x; t < L * M; t += blockDim.x) {
    cs[2 * M * M + t] = planar_at(c.parts, M, t / M, t % M);
  }
  for (int t = threadIdx.x; t < M; t += blockDim.x) {
    cs[2 * M * M + L * M + t] = make_float2(__ldg(c.taps + t), __ldg(c.taps + M + t));
  }
}

// cp.async copies from device to shared memory, all in flight until
// fac_cp_wait: 4 bytes between any two words, 16 between 16-byte aligned ones
__device__ __forceinline__ void fac_cp4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void fac_cp16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void fac_cp_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// a * b (complex)
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a times -i (forward) or +i (inverse)
template <bool INV>
__device__ __forceinline__ float2 rot(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// R-point DFT of v (natural order in and out), forward W = exp(-2 pi i / R)
// or inverse (unscaled)
template <bool INV>
__device__ __forceinline__ void dft_reg(float2 (&v)[2]) {
  const float2 t = v[0];
  v[0] = cadd(t, v[1]);
  v[1] = csub(t, v[1]);
}

template <bool INV>
__device__ __forceinline__ void dft_reg(float2 (&v)[4]) {
  const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
  const float2 t2 = cadd(v[1], v[3]), t3 = rot<INV>(csub(v[1], v[3]));
  v[0] = cadd(t0, t2);
  v[1] = cadd(t1, t3);
  v[2] = csub(t0, t2);
  v[3] = csub(t1, t3);
}

template <bool INV>
__device__ __forceinline__ void dft_reg(float2 (&v)[8]) {
  constexpr float c = 0.70710678118654752f;
  float2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
  dft_reg<INV>(e);
  dft_reg<INV>(o);
  // o[p] *= W_8^p: (1 -+ i) c, -+i, (-1 -+ i) c
  const float2 o1 = o[1], o3 = o[3];
  o[1] = INV ? make_float2(c * (o1.x - o1.y), c * (o1.x + o1.y))
             : make_float2(c * (o1.x + o1.y), c * (o1.y - o1.x));
  o[2] = rot<INV>(o[2]);
  o[3] = INV ? make_float2(-c * (o3.x + o3.y), c * (o3.x - o3.y))
             : make_float2(c * (o3.y - o3.x), -c * (o3.x + o3.y));
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    v[p] = cadd(e[p], o[p]);
    v[p + 4] = csub(e[p], o[p]);
  }
}

// bit reversal of q < R
template <int R>
__host__ __device__ constexpr int brev_r(int q) {
  return R == 8 ? ((q & 1) << 2) | (q & 2) | (q >> 2) : R == 4 ? ((q & 1) << 1) | (q >> 1) : q;
}

template <int R>
__host__ __device__ constexpr int lg_radix() {
  return R == 8 ? 3 : R == 4 ? 2 : 1;
}

// One radix-R pass over the M rows, in place: the transforms grow from
// length s = 2^lgs to R s. Butterfly (row, block, j) reads the points
// block R s + j + brev(q) s, twiddles point q by the pass's slice
// tw[(q - 1) s + j], and writes output p to block R s + j + p s.
template <int R, bool INV>
__device__ __forceinline__ void fft_pass(float2* rows, int M, int stride, int lgK, int lgs,
                                         const float2* tw) {
  constexpr int LR = lg_radix<R>();
  const int lg_row = lgK - LR, s = 1 << lgs;  // K / R butterflies a row
  for (int u = threadIdx.x; u < M << lg_row; u += blockDim.x) {
    const int row = u >> lg_row, w = u & ((1 << lg_row) - 1);
    const int j = w & (s - 1), e0 = ((w >> lgs) << (lgs + LR)) + j;
    float2* base = rows + row * stride;
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = base[fac_pos(e0 + brev_r<R>(q) * s)];
    if (s > 1) {
#pragma unroll
      for (int q = 1; q < R; ++q) v[q] = cmul(v[q], tw[(q - 1) * s + j]);
    }
    dft_reg<INV>(v);
#pragma unroll
    for (int p = 0; p < R; ++p) base[fac_pos(e0 + p * s)] = v[p];
  }
}

// The FFT of the M rows (bit-reversed in, natural out), one barrier a pass.
template <bool INV>
__device__ void fft_rows(float2* rows, const float2* tw, int K, int M) {
  const int lgK = fac_log2(K), stride = fac_stride(K);
  int off = 0, lgs = 0;
  for (int p = 0; p < fac_passes(K); ++p) {
    const int r = fac_radix(K, p);
    if (r == 8) {
      fft_pass<8, INV>(rows, M, stride, lgK, lgs, tw + off);
    } else if (r == 4) {
      fft_pass<4, INV>(rows, M, stride, lgK, lgs, tw + off);
    } else {
      fft_pass<2, INV>(rows, M, stride, lgK, lgs, tw + off);
    }
    off += (r - 1) << lgs;
    lgs += r == 8 ? 3 : r == 4 ? 2 : 1;
    __syncthreads();
  }
}

// Element n2 of a row at its place: bit-reversed for the FFT's input.
__device__ __forceinline__ int fac_in_slot(int n2, bool fft, int lgK) {
  return fac_pos(fft ? static_cast<int>(__brev(static_cast<unsigned>(n2)) >> (32 - lgK)) : n2);
}

// The direct path: K-point DFTs of the M natural-order rows of `in`:
// out(r, k) = sum_j in(r, j) wk[(j k) mod K]; epi(r, k, value) places each.
// A thread takes FAC_ROWS rows of one bin, so each twiddle load feeds them
// all; the rows are broadcast loads within a warp.
template <typename Epi>
__device__ __forceinline__ void dft_rows(const float2* in, const float2* wk,
                                         int K, int M, Epi epi) {
  const int groups = (M + FAC_ROWS - 1) / FAC_ROWS, stride = fac_stride(K);
  for (int item = threadIdx.x; item < groups * K; item += blockDim.x) {
    const int g = item / K, k = item - g * K, r0 = g * FAC_ROWS;
    const float2* rows[FAC_ROWS];
    float2 acc[FAC_ROWS];
#pragma unroll
    for (int r = 0; r < FAC_ROWS; ++r) {
      rows[r] = in + min(r0 + r, M - 1) * stride;  // rows past M repeat the last
      acc[r] = make_float2(0.f, 0.f);
    }
    int idx = 0;  // (j k) mod K
    for (int j = 0; j < K; ++j) {
      const float2 w = wk[idx];
      idx += k;
      if (idx >= K) idx -= K;
      const int pj = fac_pos(j);
#pragma unroll
      for (int r = 0; r < FAC_ROWS; ++r) acc[r] = cmla(acc[r], rows[r][pj], w);
    }
#pragma unroll
    for (int r = 0; r < FAC_ROWS; ++r) {
      if (r0 + r < M) epi(r0 + r, k, acc[r]);
    }
  }
}

// MT: the timeslots M as a compile-time constant (9, the large-K configs':
// every M-point loop unrolls, one thread a subcarrier keeps its column in
// registers), or 0 for any M read from d (one thread a symbol). Both sum in
// the same order. At M = 9 the MT = 0 body takes ~1.4x (Tx) and ~2x
// (receiver, two IC iterations) the time on an H100
// (gfdm_tpu_torch/benchmarks/factored_kernels.py): its IC reads each
// neighbour decision M times from shared memory. SMALL: the K <= FAC_SMALL_K
// bound (FAC_SMALL_THREADS threads, eight CTAs an SM).
template <int VEC, int MT, bool SMALL>
__global__ void __launch_bounds__(SMALL ? FAC_SMALL_THREADS : FAC_MAX_THREADS, SMALL ? 8 : 2)
rx_factored_kernel(FactoredDims d, FactoredConsts c,
                   const float* __restrict__ bursts,
                   const float* __restrict__ chan, float* __restrict__ sym) {
  extern __shared__ float2 fsm[];
  const int K = d.subcarriers, M = MT > 0 ? MT : d.timeslots, n = d.n, L = d.frame_len;
  const int stride = fac_stride(K), lgK = fac_log2(K), Lo = d.overlap;
  const bool fft = fac_fft(K);
  const int b = blockIdx.x;
  float2* wk = fsm;                          // twiddles (fac_twiddles)
  float2* A = wk + fac_even(K);              // two stages of M padded rows
  float2* Bs = A + fac_stage(K, M);
  float2* fmS = Bs + fac_stage(K, M);        // small constants (fac_consts)
  const float2 *ifmS = fmS + M * M, *partS = ifmS + M * M, *tapS = partS + Lo * M;
  const float* src = bursts + static_cast<size_t>(b) * 2 * L;
  const float* hin = chan + static_cast<size_t>(b) * 2 * n;
  const int fs = d.preamble_len + d.cp_len;
  // copies in flight together, while the tables are built: the payload
  // block, sample t = M n2 + n1 -> row n1, element n2 of A; with the FFT,
  // the channel (planar) into Bs
  float* Bf = reinterpret_cast<float*>(Bs);
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int n2 = t / M, n1 = t - n2 * M;
    float2* a = A + n1 * stride + fac_in_slot(n2, fft, lgK);
    fac_cp4(&a->x, src + fs + t);
    fac_cp4(&a->y, src + L + fs + t);
  }
  if (fft) {
    for (int t = threadIdx.x; t < 2 * n / VEC; t += blockDim.x) {
      if (VEC == 4) {
        fac_cp16(Bf + 4 * t, hin + 4 * t);
      } else {
        fac_cp4(Bf + t, hin + t);
      }
    }
  }
  fac_twiddles(wk, c.fk, K, 1.f);
  fac_consts(fmS, c, M, Lo);
  fac_cp_wait();
  __syncthreads();

  // 1. K-point DFTs of the M rows: Z[n1, k2] at element k2 of row n1 of Z
  //    (in place in A for the FFT, into Bs for the direct DFT); O the other
  float2 *Z = A, *O = Bs;
  if (fft) {
    fft_rows<false>(A, wk, K, M);
  } else {
    dft_rows(A, wk, K, M, [&](int r, int k, float2 v) { Bs[r * stride + fac_pos(k)] = v; });
    __syncthreads();
    Z = Bs;
    O = A;
  }

  // 2. the channel H, planar in O: read now for the direct DFT (with the FFT
  //    it came with the payload)
  float* Of = reinterpret_cast<float*>(O);
  if (!fft) {
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      Of[t] = __ldcs(hin + t);
      Of[n + t] = __ldcs(hin + n + t);
    }
    __syncthreads();
  }

  // 3. twiddle, M-point stage (natural-order spectrum X) and ZF: Y over H in O
  for (int k2 = threadIdx.x; k2 < K; k2 += blockDim.x) {
    float2* z = Z + fac_pos(k2);
    float2 zr[MT > 0 ? MT : 1];  // MT: the twiddled column in registers
#pragma unroll
    for (int n1 = 0; n1 < M; ++n1) {
      const float2 v = cmul(z[n1 * stride], planar_at(c.tw, K, n1, k2));
      if constexpr (MT > 0) {
        zr[n1] = v;
      } else {
        z[n1 * stride] = v;
      }
    }
#pragma unroll
    for (int k1 = 0; k1 < M; ++k1) {
      float2 x = make_float2(0.f, 0.f);
#pragma unroll
      for (int n1 = 0; n1 < M; ++n1) {
        float2 zn;
        if constexpr (MT > 0) {
          zn = zr[n1];
        } else {
          zn = z[n1 * stride];
        }
        x = cmla(x, zn, fmS[n1 * M + k1]);
      }
      const int col = k1 * K + k2;
      const float2 h = make_float2(Of[col], Of[n + col]);
      const float den = fmaxf(h.x * h.x + h.y * h.y, 1e-30f);
      Of[col] = (x.x * h.x + x.y * h.y) / den;
      Of[n + col] = (x.y * h.x - x.x * h.y) / den;
    }
  }
  __syncthreads();

  // 4-5. fold of the L filter parts (S) and per-subcarrier M-point IFFTs: d0
  //      into D. MT: one thread a subcarrier, S in registers, d0 into Z;
  //      any M: one thread a symbol, S into Z, then d0 into O.
  float2* D = O;
  if constexpr (MT > 0) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      float2 sv[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) sv[m] = make_float2(0.f, 0.f);
      for (int i = 0; i < Lo; ++i) {
        int kk = k + i - Lo / 2;
        kk = kk < 0 ? kk + K : (kk >= K ? kk - K : kk);
        const int part = i + Lo / 2 - (i + Lo / 2 >= Lo ? Lo : 0);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int x = kk * MT + m;
          sv[m] = cmla(sv[m], make_float2(Of[x], Of[n + x]), partS[part * MT + m]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float2 x = make_float2(0.f, 0.f);
#pragma unroll
        for (int j = 0; j < MT; ++j) x = cmla(x, sv[j], ifmS[j * MT + m]);
        Z[k * MT + m] = x;
      }
    }
    D = Z;
  } else {
    for (int col = threadIdx.x; col < n; col += blockDim.x) {
      const int k = col / M, m = col - k * M;
      float2 s = make_float2(0.f, 0.f);
      for (int i = 0; i < Lo; ++i) {
        int kk = k + i - Lo / 2;
        kk = kk < 0 ? kk + K : (kk >= K ? kk - K : kk);
        const int part = i + Lo / 2 - (i + Lo / 2 >= Lo ? Lo : 0);
        s = cmla(s, make_float2(Of[kk * M + m], Of[n + kk * M + m]), partS[part * M + m]);
      }
      Z[col] = s;
    }
    __syncthreads();
    for (int col = threadIdx.x; col < n; col += blockDim.x) {
      const int k = col / M, m = col - k * M;
      float2 x = make_float2(0.f, 0.f);
      for (int j = 0; j < M; ++j) x = cmla(x, Z[k * M + j], ifmS[j * M + m]);
      O[col] = x;
    }
  }
  __syncthreads();

  // 6. interference cancellation on d0: neighbour subcarriers k-1, k+1
  //    (mod K), tap j on timeslot (m - j) mod M, summed over j in order, of
  //    the decisions +-1 (0 off the active subcarriers; act is constant over
  //    a subcarrier's M symbols) of the last estimate, d0 first. The
  //    decisions are bytes in two buffers in the stage D does not hold, d0's
  //    taken in a pass of their own, so the last iteration may write the
  //    symbols over d0 (each thread its own) while others still decide.
  char2* q0 = reinterpret_cast<char2*>(D == Z ? O : Z);
  char2* q1 = q0 + n;
  auto decide = [&](float2 v, float a) {
    const signed char s = a > 0.f ? 1 : 0;
    return make_char2(v.x >= 0.f ? s : -s, v.y >= 0.f ? s : -s);
  };
  const int iters = d.ic_iterations;
  if (iters > 0) {
    for (int col = threadIdx.x; col < n; col += blockDim.x) {
      q0[col] = decide(D[col], __ldg(c.act + col));
    }
    __syncthreads();
  }
  for (int it = 0; it < iters; ++it) {
    const char2* cur = it & 1 ? q1 : q0;
    char2* nxt = it & 1 ? q0 : q1;
    const bool last = it == iters - 1;
    if constexpr (MT > 0) {  // one thread a subcarrier, its 2 M decisions in registers
      for (int k = threadIdx.x; k < K; k += blockDim.x) {
        const int lo = (k == 0 ? K - 1 : k - 1) * MT, hi = (k == K - 1 ? 0 : k + 1) * MT;
        float ur[MT], ui[MT], ir[MT], ii[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const char2 u = cur[lo + m], w = cur[hi + m];
          ur[m] = static_cast<float>(u.x + w.x);
          ui[m] = static_cast<float>(u.y + w.y);
          ir[m] = 0.f;
          ii[m] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const float2 t = tapS[j];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int mm = (m - j + MT) % MT;
            ir[m] = ir[m] + t.x * ur[mm] - t.y * ui[mm];
            ii[m] = ii[m] + t.x * ui[mm] + t.y * ur[mm];
          }
        }
        const float a_k = __ldg(c.act + k * MT);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int col = k * MT + m;
          const float2 d0 = D[col], v = make_float2(d0.x - ir[m], d0.y - ii[m]);
          if (last) {
            D[col] = v;
          } else {
            nxt[col] = decide(v, a_k);
          }
        }
      }
    } else {
      for (int col = threadIdx.x; col < n; col += blockDim.x) {
        const int k = col / M, m = col - k * M;
        const int lo = (k == 0 ? K - 1 : k - 1) * M, hi = (k == K - 1 ? 0 : k + 1) * M;
        float ir = 0.f, ii = 0.f;
        for (int j = 0; j < M; ++j) {
          int mm = m - j;
          if (mm < 0) mm += M;
          const char2 u = cur[lo + mm], w = cur[hi + mm];
          const float sr = static_cast<float>(u.x + w.x), si = static_cast<float>(u.y + w.y);
          const float2 t = tapS[j];
          ir = ir + t.x * sr - t.y * si;
          ii = ii + t.x * si + t.y * sr;
        }
        const float2 d0 = D[col], v = make_float2(d0.x - ir, d0.y - ii);
        if (last) {
          D[col] = v;
        } else {
          nxt[col] = decide(v, __ldg(c.act + col));
        }
      }
    }
    __syncthreads();
  }
  float* out = sym + static_cast<size_t>(b) * 2 * n;
  for (int c4 = threadIdx.x; c4 < n / VEC; c4 += blockDim.x) {
    if (VEC == 4) {
      const float2 v0 = D[4 * c4], v1 = D[4 * c4 + 1], v2 = D[4 * c4 + 2], v3 = D[4 * c4 + 3];
      __stcs(reinterpret_cast<float4*>(out) + c4, make_float4(v0.x, v1.x, v2.x, v3.x));
      __stcs(reinterpret_cast<float4*>(out + n) + c4, make_float4(v0.y, v1.y, v2.y, v3.y));
    } else {
      out[c4] = D[c4].x;
      out[n + c4] = D[c4].y;
    }
  }
}

template <int VEC, int MT>
__global__ void __launch_bounds__(FAC_MAX_THREADS, 2)
tx_factored_kernel(FactoredDims d, FactoredConsts c,
                   const float* __restrict__ data, float* __restrict__ out) {
  extern __shared__ float2 fsm[];
  const int K = d.subcarriers, M = MT > 0 ? MT : d.timeslots, n = d.n, n_d = d.n_data;
  const int stride = fac_stride(K), lgK = fac_log2(K), Lo = d.overlap;
  const bool fft = fac_fft(K);
  const int b = blockIdx.x;
  float2* wk = fsm;                          // twiddles of exp(+2 pi i t / K), unit for the FFT
  float2* A = wk + fac_even(K);              // two stages of M padded rows
  float2* Bs = A + fac_stage(K, M);
  float2* fmS = Bs + fac_stage(K, M);        // small constants (fac_consts)
  const float2 *ifmS = fmS + M * M, *partS = ifmS + M * M;
  const float* src = data + static_cast<size_t>(b) * 2 * n_d;
  // the payload, copied into Bs (16 bytes a copy where the planes allow)
  // while the tables are built
  float* pay = reinterpret_cast<float*>(Bs);
  for (int t = threadIdx.x; t < 2 * n_d / VEC; t += blockDim.x) {
    if (VEC == 4) {
      fac_cp16(pay + 4 * t, src + 4 * t);
    } else {
      fac_cp4(pay + t, src + t);
    }
  }
  fac_twiddles(wk, c.fk, K, fft ? static_cast<float>(K) : 1.f);
  fac_consts(fmS, c, M, Lo);
  fac_cp_wait();
  __syncthreads();

  // 1. resource map (grid position col holds payload symbol map_idx[col], n_d
  //    a zero) and per-subcarrier M-point DFTs: into Dp. MT: one thread a
  //    subcarrier, its M grid symbols in registers, into A; any M: the map
  //    into A, then one thread a symbol into Bs.
  auto grid = [&](int col) {
    const int j = __ldg(c.map_idx + col);
    return j < n_d ? make_float2(pay[j], pay[n_d + j]) : make_float2(0.f, 0.f);
  };
  float2 *Dp = Bs, *Xp = A;
  if constexpr (MT > 0) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      float2 g[MT];
#pragma unroll
      for (int j = 0; j < MT; ++j) g[j] = grid(k * MT + j);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float2 x = make_float2(0.f, 0.f);
#pragma unroll
        for (int j = 0; j < MT; ++j) x = cmla(x, g[j], fmS[j * MT + m]);
        A[k * MT + m] = x;
      }
    }
    Dp = A;
    Xp = Bs;
  } else {
    for (int col = threadIdx.x; col < n; col += blockDim.x) A[col] = grid(col);
    __syncthreads();
    for (int col = threadIdx.x; col < n; col += blockDim.x) {
      const int k = col / M, m = col - k * M;
      float2 x = make_float2(0.f, 0.f);
      for (int j = 0; j < M; ++j) x = cmla(x, A[k * M + j], fmS[j * M + m]);
      Bs[col] = x;
    }
  }
  __syncthreads();

  // 2. overlap-add of the L filter parts, into Xp (natural-order spectrum)
  for (int col = threadIdx.x; col < n; col += blockDim.x) {
    const int k = col / M, m = col - k * M;
    float2 s = make_float2(0.f, 0.f);
    for (int i = 0; i < Lo; ++i) {
      int kk = k - i + Lo / 2;
      kk = kk < 0 ? kk + K : (kk >= K ? kk - K : kk);
      const int part = i + Lo / 2 - (i + Lo / 2 >= Lo ? Lo : 0);
      s = cmla(s, Dp[kk * M + m], partS[part * M + m]);
    }
    Xp[col] = s;
  }
  __syncthreads();

  // 3. M-point stage of the N-point IDFT, then the conjugate twiddle: row n1,
  //    element k2 of Dp (free again)
  for (int k2 = threadIdx.x; k2 < K; k2 += blockDim.x) {
    float2* z = Dp + fac_in_slot(k2, fft, lgK);
    float2 ar[MT > 0 ? MT : 1];  // MT: the column in registers
    if constexpr (MT > 0) {
#pragma unroll
      for (int k1 = 0; k1 < MT; ++k1) ar[k1] = Xp[k1 * K + k2];
    }
#pragma unroll
    for (int n1 = 0; n1 < M; ++n1) {
      float2 x = make_float2(0.f, 0.f);
#pragma unroll
      for (int k1 = 0; k1 < M; ++k1) {
        float2 a;
        if constexpr (MT > 0) {
          a = ar[k1];
        } else {
          a = Xp[k1 * K + k2];
        }
        x = cmla(x, a, ifmS[k1 * M + n1]);
      }
      z[n1 * stride] = cmul(x, planar_at(c.tw, K, n1, k2));
    }
  }
  __syncthreads();

  // 4. K-point IDFTs: core sample t = M n2 + n1 at element n2 of row n1 of
  //    `core` (in place in Dp for the FFT, into Xp for the direct DFT)
  const float2* core = Dp;
  if (fft) {
    fft_rows<true>(Dp, wk, K, M);
  } else {
    dft_rows(Dp, wk, K, M, [&](int r, int k, float2 v) { Xp[r * stride + fac_pos(k)] = v; });
    __syncthreads();
    core = Xp;
  }

  // 5. the burst: preamble, then the windowed core (times 1/K after the FFT,
  //    exact) at the CP/CS positions of the cyclic shift (framed sample j
  //    holds core sample (j - cp - shift) mod N)
  const int Lf = d.frame_len, p_len = d.preamble_len, lead = d.cp_len + d.shift;
  const float scale = fft ? 1.f / static_cast<float>(K) : 1.f;
  for (int p = 0; p < 2; ++p) {
    float* dst = out + (static_cast<size_t>(b) * 2 + p) * Lf;
    for (int t4 = threadIdx.x; t4 < Lf / VEC; t4 += blockDim.x) {
      float v[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int t = VEC * t4 + e;
        if (t < p_len) {
          v[e] = __ldg(c.pre + p * p_len + t);
        } else {
          const int j = t - p_len;
          int col = j - lead;
          col = col < 0 ? col + n : (col >= n ? col - n : col);
          const int n2 = col / M, n1 = col - n2 * M;
          const float2 s = core[n1 * stride + fac_pos(n2)];
          v[e] = (p == 0 ? s.x : s.y) * scale * __ldg(c.win + j);
        }
      }
      if (VEC == 4) {
        __stcs(reinterpret_cast<float4*>(dst) + t4, make_float4(v[0], v[1], v[2], v[3]));
      } else {
        dst[t4] = v[0];
      }
    }
  }
}

// The channel estimate of estimator="fused": chan (B, 2, N) = A @ E_W, A's
// row b the preamble window of burst b read in place (see the head of this
// file); a 64-burst x 128-column tile a CTA on fma_gemm.cuh's body. A16:
// 16-byte copies of A (cp_len, frame_len and 2K multiples of 4), else 4-byte
// ones; W16: 16-byte copies of E_W and stores of chan (2N a multiple of 4),
// else 4-byte ones. Rows past B, columns past 2N and k past 4K arrive as
// zeros and are not stored.
template <bool A16, bool W16>
__global__ void __launch_bounds__(fg::THREADS, 3)
rx_estimate_kernel(FactoredDims d, const float* __restrict__ bursts,
                   const float* __restrict__ e_w, float* __restrict__ chan) {
  extern __shared__ __align__(16) float esm[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = d.batch, K2 = 2 * d.subcarriers, kd = 2 * K2, cols = 2 * d.n;
  const int L = d.frame_len, cp = d.cp_len;
  const int m0 = blockIdx.y * fg::BM, n0 = blockIdx.x * fg::BN;
  // A's element (r, k): plane k / 2K of burst r, sample cp + k % 2K
  auto a_at = [&](int r, int k) {
    return bursts + static_cast<size_t>(r) * 2 * L + (k < K2 ? cp + k : L + cp + (k - K2));
  };
  float acc[fg::TM][fg::TN];
  fg::mainloop(acc, esm, (kd + fg::BK - 1) / fg::BK, [&](float* slot, int k0) {
    float* as = slot;
    float* ws = slot + fg::BM * fg::BK;
    if constexpr (A16) {
#pragma unroll
      for (int i = 0; i < fg::BM * fg::BK / 4 / fg::THREADS; ++i) {
        const int c = tid + i * fg::THREADS, r = c >> 2, kq = 4 * (c & 3), k = k0 + kq;
        const bool ok = m0 + r < rows && k < kd;
        fg::cp_async16_zfill(as + r * fg::BK + kq, ok ? a_at(m0 + r, k) : bursts, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < fg::BM * fg::BK / fg::THREADS; ++i) {
        const int c = tid + i * fg::THREADS, r = c >> 4, kk = c & 15, k = k0 + kk;
        const bool ok = m0 + r < rows && k < kd;
        fg::cp_async4_zfill(as + r * fg::BK + kk, ok ? a_at(m0 + r, k) : bursts, ok);
      }
    }
    if constexpr (W16) {
#pragma unroll
      for (int i = 0; i < fg::BK * fg::BN / 4 / fg::THREADS; ++i) {
        const int c = tid + i * fg::THREADS, r = c >> 5, col = 4 * (c & 31);
        const bool ok = k0 + r < kd && n0 + col < cols;
        fg::cp_async16_zfill(ws + r * fg::BN + col,
                             ok ? e_w + static_cast<size_t>(k0 + r) * cols + n0 + col : e_w, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < fg::BK * fg::BN / fg::THREADS; ++i) {
        const int c = tid + i * fg::THREADS, r = c >> 7, col = c & 127;
        const bool ok = k0 + r < kd && n0 + col < cols;
        fg::cp_async4_zfill(ws + r * fg::BN + col,
                            ok ? e_w + static_cast<size_t>(k0 + r) * cols + n0 + col : e_w, ok);
      }
    }
  });
  // thread block: rows ty + 8 i, columns 4 tx + 64 h + e (acc[i][4 h + e])
#pragma unroll
  for (int i = 0; i < fg::TM; ++i) {
    const int row = m0 + ty + fg::TY * i;
    if (row >= rows) continue;
    float* dst = chan + static_cast<size_t>(row) * cols;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = n0 + 4 * tx + 64 * h;
      if constexpr (W16) {
        if (c0 < cols) {
          *reinterpret_cast<float4*>(dst + c0) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c0 + e < cols) dst[c0 + e] = acc[i][4 * h + e];
        }
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int launch_rx_estimate(const FactoredDims* d, const float* bursts, const float* e_w,
                       float* chan, void* stream) {
  if (d->batch <= 0) return 0;
  const int cols = 2 * d->n;
  const bool a16 = d->cp_len % 4 == 0 && d->frame_len % 4 == 0 && d->subcarriers % 2 == 0 &&
                   aligned16(bursts);
  const bool w16 = cols % 4 == 0 && aligned16(e_w) && aligned16(chan);
  const dim3 grid((cols + fg::BN - 1) / fg::BN, (d->batch + fg::BM - 1) / fg::BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  (void)cudaGetLastError();  // report this launch's error only (earlier calls reported theirs)
  if (a16 && w16) {
    rx_estimate_kernel<true, true><<<grid, fg::THREADS, fg::SMEM, st>>>(*d, bursts, e_w, chan);
  } else if (w16) {
    rx_estimate_kernel<false, true><<<grid, fg::THREADS, fg::SMEM, st>>>(*d, bursts, e_w, chan);
  } else {  // 2N not a multiple of 4: K odd, so 2K is not either
    rx_estimate_kernel<false, false><<<grid, fg::THREADS, fg::SMEM, st>>>(*d, bursts, e_w, chan);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch `kernel` one CTA a burst, `threads` a CTA.
template <typename Kernel, typename... Args>
int launch_factored(Kernel kernel, const FactoredDims* d, size_t smem, int threads,
                    void* stream, Args... args) {
  (void)cudaGetLastError();  // report this launch's error only (earlier calls reported theirs)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // a refused launch leaves no error behind
    return static_cast<int>(err);
  }
  kernel<<<d->batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(*d, args...);
  return static_cast<int>(cudaGetLastError());
}

// The receiver's threads a CTA: at K <= FAC_SMALL_K the small CTA's.
inline int rx_threads(const FactoredDims& d) {
  return fac_small(d) ? FAC_SMALL_THREADS : factored_threads(d);
}

// The receiver's bound: K <= FAC_SMALL_K the small CTA, else the wide one.
template <int VEC, int MT>
int launch_rx_mt(const FactoredDims* d, size_t smem, void* stream, const FactoredConsts& c,
                 const float* bursts, const float* chan, float* sym) {
  if (fac_small(*d)) {
    return launch_factored(rx_factored_kernel<VEC, MT, true>, d, smem, rx_threads(*d), stream,
                           c, bursts, chan, sym);
  }
  return launch_factored(rx_factored_kernel<VEC, MT, false>, d, smem, rx_threads(*d), stream,
                         c, bursts, chan, sym);
}

// M = 9 (the large-K configs) takes the kernels' MT = 9 instantiations, any
// other M the MT = 0 ones.
int launch_rx_factored(const FactoredDims* d, const FactoredConsts* c, const float* bursts,
                       const float* chan, float* sym, void* stream) {
  if (d->batch <= 0) return 0;
  const size_t smem = factored_smem_bytes(*d);
  // 16-byte burst and channel reads and symbol writes where every plane
  // offset allows
  const bool vec = (d->preamble_len + d->cp_len) % 4 == 0 && d->frame_len % 4 == 0 &&
                   d->n % 4 == 0 && aligned16(bursts) && aligned16(chan) && aligned16(sym);
  if (d->timeslots == 9) {
    return vec ? launch_rx_mt<4, 9>(d, smem, stream, *c, bursts, chan, sym)
               : launch_rx_mt<1, 9>(d, smem, stream, *c, bursts, chan, sym);
  }
  return vec ? launch_rx_mt<4, 0>(d, smem, stream, *c, bursts, chan, sym)
             : launch_rx_mt<1, 0>(d, smem, stream, *c, bursts, chan, sym);
}

int launch_tx_factored(const FactoredDims* d, const FactoredConsts* c, const float* data,
                       float* out, void* stream) {
  if (d->batch <= 0) return 0;
  const size_t smem = factored_smem_bytes(*d);
  const int threads = factored_threads(*d);
  // 16-byte payload reads and burst writes where the planes allow
  const bool vec = d->frame_len % 4 == 0 && d->n_data % 4 == 0 && aligned16(data) &&
                   aligned16(out);
  if (d->timeslots == 9) {
    return vec ? launch_factored(tx_factored_kernel<4, 9>, d, smem, threads, stream, *c, data,
                                 out)
               : launch_factored(tx_factored_kernel<1, 9>, d, smem, threads, stream, *c, data,
                                 out);
  }
  return vec ? launch_factored(tx_factored_kernel<4, 0>, d, smem, threads, stream, *c, data, out)
             : launch_factored(tx_factored_kernel<1, 0>, d, smem, threads, stream, *c, data, out);
}

}  // namespace gfdm

extern "C" int gfdm_tx_factored(const gfdm::FactoredDims* d,
                                const gfdm::FactoredConsts* c, const float* data,
                                float* out, void* stream) {
  return gfdm::launch_tx_factored(d, c, data, out, stream);
}

// The receiver with its own estimator: two launches, the estimator GEMM
// (bursts, e_w (4K, 2N) -> chan) and the receiver on that channel.
extern "C" int gfdm_rx_factored(const gfdm::FactoredDims* d,
                                const gfdm::FactoredConsts* c, const float* bursts,
                                const float* e_w, float* chan, float* sym, void* stream) {
  const int rc = gfdm::launch_rx_estimate(d, bursts, e_w, chan, stream);
  return rc != 0 ? rc : gfdm::launch_rx_factored(d, c, bursts, chan, sym, stream);
}

// The estimator GEMM alone.
extern "C" int gfdm_rx_estimate(const gfdm::FactoredDims* d, const float* bursts,
                                const float* e_w, float* chan, void* stream) {
  return gfdm::launch_rx_estimate(d, bursts, e_w, chan, stream);
}

// The receiver on a given channel.
extern "C" int gfdm_rx_factored_chan(const gfdm::FactoredDims* d,
                                     const gfdm::FactoredConsts* c, const float* bursts,
                                     const float* chan, float* sym, void* stream) {
  return gfdm::launch_rx_factored(d, c, bursts, chan, sym, stream);
}

// Shared memory of the Tx's and the receiver's CTA.
extern "C" size_t gfdm_factored_smem_bytes(const gfdm::FactoredDims* d) {
  return gfdm::factored_smem_bytes(*d);
}

// The estimator GEMM's tile: out = (bursts, columns, k-depth) of a CTA.
extern "C" int gfdm_rx_estimate_tile(int* out) {
  out[0] = gfdm::fg::BM;
  out[1] = gfdm::fg::BN;
  out[2] = gfdm::fg::BK;
  return 0;
}

// The K-point stage's plan at K: out[0] the row stride, out[1..] the FFT's
// radices; returns the number of passes (0: the direct DFT).
extern "C" int gfdm_factored_plan(int K, int* out) {
  out[0] = gfdm::fac_stride(K);
  const int passes = gfdm::fac_passes(K);
  for (int p = 0; p < passes; ++p) out[1 + p] = gfdm::fac_radix(K, p);
  return passes;
}

extern "C" int gfdm_factored_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(gfdm::FactoredDims));
  out[1] = static_cast<int>(sizeof(gfdm::FactoredConsts));
  return 0;
}
