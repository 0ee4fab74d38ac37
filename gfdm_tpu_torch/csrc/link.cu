// The GFDM loopback link and the dense receiver for Hopper (sm_90a), as
// staged tensor-core products.
//
// Two launch plans over one set of stage kernels (gfdm_link_stage):
//
// The link replaces the Pallas kernel gfdm_tpu/kernels/fused.py::
// _link_kernel (:1403; wrapper link_single_fused): payload (B, 2 n_data) ->
// the transmitter at cyclic shift 0 -> the receiver on the framed burst
// (channel estimate, SNR/CNR metrics, N-point DFT, ZF with |C|^2 clamped at
// 1e-30, FD demod, ic_iterations of decision-directed IC with QPSK, qam16
// or qam64 decisions, either IC mode) -> demap -> data estimate
// (B, 2 n_data) and metrics (B, met_w). Stages, in order:
//   0 tx      F  = (payload @ T_G) * win[cp + col], and P, the framed
//             burst's preamble window (columns cp .. cp + 2K of each plane)
//   1 est_zf  C  = P @ E_G (parked in shared memory), X = F @ F_G,
//             Y  = ZF(X, C) times the equalizer's weight
//   2 pre_dft pw = |P @ F2_G|^2
//   3 metrics met rows from pw's signal and noise bins
//   4 demod   D0 = Y @ Bfd_G; then Q = level(D0) * act, or (no IC) the
//             demapped output
//   5 ic      one launch an iteration: D = D0 - Q @ icop (bf16 operator) or
//             D0 - the M-tap circulant of Q (conv: a stencil on CUDA cores);
//             then the next Q, or the last iteration's demapped output
// P is a (B, 4K) buffer like F: each burst's estimate and metrics read its
// own row, as the TPU kernel reads each burst's own window. Q ping-pongs
// through F and Y, which are dead by then.
//
// The dense receiver replaces the Pallas kernel _rx_ic_circ_kernel (:343;
// wrappers rx_receiver_fused, receive_bursts_fused) with every option:
// bursts (B, 2 frame_len) -> channel (B, 2N), symbols (B, 2N) and metrics
// (B, met_w). Its stages read the caller's bursts in place: P and F are
// Acts into each burst row (the preamble window at cp, the payload block
// at preamble_len + cp, plane pitch frame_len), never copied and never
// written. Plan: pre_dft, metrics, est_zf (which reads the metrics for the
// mmse / mmse_cnr weight and writes the channel), demod, 6 phase (with
// phase_comp and IC: the one-shot common-phase correction of D0, one warp a
// burst), then one IC launch an iteration. Q has its own buffer and
// ping-pongs with Y; the last stage writes the symbols whole (no demap).
// Its float32-stack products sum in float64 on the FP64 tensor cores
// (Dims::sum64; float32 operands multiply exactly there) and round once:
// with 3xTF32 float32-level sums in another order than the plain
// version's, 24 of 16,384 noisy qam64 bursts (1.5e-3) took an IC decision
// on the other side of a level boundary; so it matches the plain version
// summed in float64 decision for decision.
//
// Each product stage is the engine of link_gemm.cuh: 128-burst x 64-column
// tiles, column tile fastest in the grid (the tiles of one burst tile run
// together and share its activation rows in L2), operator and activation
// slabs staged by cp.async in a two-slot ring, so each operator is read
// once per 128 bursts (~8 GB of L2 reads a step at B = 65,536), products on
// tensor cores: 3xTF32 for the float32 stacks, bf16 for the IC operator
// and, with the link's dtype "bfloat16" (Dims::bf16), for all five stacks,
// the Tx and estimate stages' exact bf16 products summed in float64
// (ROUNDED below). Any batch, ragged too, at any N whose stacks fit.
//
// Bound (H100 SXM, B = 65,536, canonical config): the link 4.02e11
// float32-stack operations x 3 TF32 products at 495 TFLOP/s plus 2.61e11 IC
// operations at 989 TFLOP/s: 2.70 ms, operation-bound; the design's
// intermediates (F, P, Y, D0, Q, pw, each written once and read by each
// stage that takes it: ~55 KB a burst, 3.6 GB) take 1.07 ms at 3.35 TB/s.
// With bf16 stacks the Tx and estimate products take 4.0 ms at the FP64
// tensor cores' 67 TFLOP/s, the rest (preamble DFT, demod, IC) 0.4 ms:
// 4.4 ms, operation-bound. The receiver, bounded as the link: 2.96e11
// float32-stack operations x 3 TF32 products at 495 TFLOP/s, 1.88 ms with
// the conv IC and 2.06 with the matmul IC, operation-bound (at the FP64
// tensor cores' 67 TFLOP/s, where it sums them, 4.50 / 4.69 ms); its bursts
// in and channel, symbols
// and metrics out 0.31 ms, its intermediates (Y, D0, Q, pw) ~0.8 ms. What
// bounds the kernels instead
// (PERF.md §6): one CTA of 8 warps an SM, so a float32 slab's 3xTF32
// splits, fragment loads and dependent mma.sync chains run with little
// latency hidden, and a bf16 slab waits on its copies with one slab in
// flight.
#include "link_gemm.cuh"

namespace gfdm {
namespace lg {

enum Stage { TX = 0, EST_ZF = 1, PRE_DFT = 2, METRICS = 3, DEMOD = 4, IC = 5, PHASE = 6 };

// With bf16 stacks the next stage rounds F and Y to bf16, so a float32 sum
// in any order but the reference's own puts a few activations on the other
// side of a rounding boundary, and one such element of Y moves its burst by
// up to ~1e-2. The Tx and estimate stages therefore sum their exact bf16
// products in float64 (FP64 tensor cores) and round once to float32: F and
// Y are then the float64-summed plain version's, element for element.
template <typename W>
constexpr bool ROUNDED = sizeof(W) == 2;

struct TileIdx {
  int row0, rows, col0;
  __device__ TileIdx(int batch)
      : row0(blockIdx.y * BM), rows(min(BM, batch - static_cast<int>(blockIdx.y) * BM)),
        col0(blockIdx.x * BN) {}
};

// for (r, c) of the staged tile with r < rows and col0 + c < n_out
template <typename F>
__device__ __forceinline__ void for_tile(const TileIdx& t, int n_out, F f) {
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e - r * BN;
    if (r < t.rows && t.col0 + c < n_out) f(r, c, t.col0 + c);
  }
}

// The first IC decisions' buffer: the receiver's own Q, else the link's F.
__host__ __device__ __forceinline__ float* first_q(const LinkIO& io) {
  return io.q != nullptr ? io.q : io.f;
}

// after D (vr, vi) at frame column col of burst row: the next IC decisions
// Q = level(D) * act, or (last) the demapped output, or the symbols
__device__ __forceinline__ void decide_or_demap(const Dims& d, const Consts& c,
                                                const LinkIO& io, float* q_out, bool last,
                                                size_t row, int col, float vr, float vi) {
  if (last && io.inv_demap == nullptr) {
    float* s = io.sym + row * 2 * d.n;
    s[col] = vr;
    s[d.n + col] = vi;
  } else if (last) {
    const int t = io.inv_demap[col];
    if (t >= 0) {
      float* o = io.out + row * 2 * d.n_data;
      o[t] = vr;
      o[d.n_data + t] = vi;
    }
  } else {
    const float a = c.act[col];
    float* q = q_out + row * 2 * d.n;
    q[col] = ic_level(vr, d.dec_kind) * a;
    q[d.n + col] = ic_level(vi, d.dec_kind) * a;
  }
}

// The equalizer's weight of bin col of burst row after ZF (den = |C|^2
// clamped), from the burst's metrics row [snr | cnrs]:
//   zf:       1
//   mmse:     den / (den + 1 / max(snr, 1e-6))
//   mmse_cnr: cb / (cb + 1), cb = max(sum_j max(cnr_j, 0) cnri[j, col], 1e-6)
__device__ __forceinline__ float eq_weight(const Dims& d, const Consts& c, const LinkIO& io,
                                           size_t row, int col, float den) {
  const float* m = io.met + row * d.met_w;
  if (d.equalizer == 1) return den / (den + 1.f / fmaxf(m[0], 1e-6f));
  if (d.equalizer != 2) return 1.f;
  float cb = 0.f;
  for (int j = 0; j < d.n_cnr; ++j) {
    cb = fmaf(fmaxf(m[1 + j], 0.f), __ldg(c.cnri + static_cast<size_t>(j) * d.n + col), cb);
  }
  cb = fmaxf(cb, 1e-6f);
  return cb / (cb + 1.f);
}

template <typename W>
__global__ void __launch_bounds__(THREADS, 1) tx_stage(Dims d, Consts c, LinkIO io) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TileIdx t(d.batch);
  float* o = reinterpret_cast<float*>(smem);
  gauss_tile<W, ROUNDED<W>>(smem, Act{io.data, 2 * d.n_data, d.n_data, d.n_data},
                static_cast<const W*>(c.t_g), d.n, t.row0, t.rows, t.col0, o);
  // core sample col sits at framed position cp + col: the payload window of
  // the burst is core * win[cp:cp + N]
  for_tile(t, d.n, [&](int r, int cc, int col) {
    const float wv = c.win[d.cp_len + col];
    float* f = io.f + static_cast<size_t>(t.row0 + r) * 2 * d.n;
    f[col] = o[r * LDO + cc] * wv;
    f[d.n + col] = o[(BM + r) * LDO + cc] * wv;
  });
  if (blockIdx.x == 0) {  // the framed burst's preamble window, one row a burst
    for (int e = threadIdx.x; e < t.rows * 2 * d.half; e += THREADS) {
      const int r = e / (2 * d.half), j = e - r * 2 * d.half, q = j / d.half;
      io.pre[static_cast<size_t>(t.row0 + r) * 2 * d.half + j] =
          c.pre[q * d.preamble_len + d.cp_len + j - q * d.half];
    }
  }
}

template <typename W, bool S64>
__global__ void __launch_bounds__(THREADS, 1) est_zf_stage(Dims d, Consts c, LinkIO io) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TileIdx t(d.batch);
  float* chan = reinterpret_cast<float*>(smem + ring_bytes<W>());
  float* o = reinterpret_cast<float*>(smem);
  gauss_tile<W, ROUNDED<W> || S64>(smem, io.p_in, static_cast<const W*>(c.e_g), d.n, t.row0,
                                   t.rows, t.col0, chan);
  gauss_tile<W, ROUNDED<W> || S64>(smem, io.f_in, static_cast<const W*>(c.f_g), d.n, t.row0,
                                   t.rows, t.col0, o);
  for_tile(t, d.n, [&](int r, int cc, int col) {
    const size_t row = t.row0 + r;
    const float hr = chan[r * LDO + cc], hi = chan[(BM + r) * LDO + cc];
    const float xr = o[r * LDO + cc], xi = o[(BM + r) * LDO + cc];
    // rounded as the plain version's separate products and sums (no FMA
    // contraction), so that Y, rounded to bf16 by the demod with bf16
    // stacks, matches it as closely as it can
    const float den = fmaxf(__fadd_rn(__fmul_rn(hr, hr), __fmul_rn(hi, hi)), 1e-30f);
    const float w = eq_weight(d, c, io, row, col, den);
    float* y = io.y + row * 2 * d.n;
    y[col] = __fadd_rn(__fmul_rn(xr, hr), __fmul_rn(xi, hi)) / den * w;
    y[d.n + col] = __fsub_rn(__fmul_rn(xi, hr), __fmul_rn(xr, hi)) / den * w;
    if (io.chan != nullptr) {
      float* h = io.chan + row * 2 * d.n;
      h[col] = hr;
      h[d.n + col] = hi;
    }
  });
}

template <typename W, bool S64>
__global__ void __launch_bounds__(THREADS, 1) pre_dft_stage(Dims d, Consts c, LinkIO io) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TileIdx t(d.batch);
  float* o = reinterpret_cast<float*>(smem);
  gauss_tile<W, S64>(smem, io.p_in, static_cast<const W*>(c.f2_g), d.half, t.row0, t.rows, t.col0,
                o);
  for_tile(t, d.half, [&](int r, int cc, int col) {
    const float yr = o[r * LDO + cc], yi = o[(BM + r) * LDO + cc];
    io.pw[static_cast<size_t>(t.row0 + r) * d.half + col] = __fadd_rn(__fmul_rn(yr, yr), __fmul_rn(yi, yi));
  });
}

// SNR / CNR of each burst from its preamble power: one warp a burst (index
// sums in place of the selection matmul), met row [snr | cnrs | 0-pad]
__global__ void __launch_bounds__(256) metrics_stage(Dims d, Consts c, LinkIO io) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * 8 + threadIdx.x / 32;
  if (b >= d.batch) return;  // uniform over the warp
  const float* x = io.pw + static_cast<size_t>(b) * d.half;
  float sig = 0.f, noise = 0.f;
  for (int j = lane; j < d.n_cnr; j += 32) {
    sig += x[c.sig_idx[j]];
    noise += x[c.noise_idx[j]];
  }
  sig = warp_sum(sig);
  noise = warp_sum(noise);
  const float snr = (sig - noise) / noise;
  const float cscale = snr / (sig / static_cast<float>(d.n_cnr));
  float* m = io.met + static_cast<size_t>(b) * d.met_w;
  for (int j = lane; j < d.met_w; j += 32) {
    m[j] = j == 0 ? snr : (j <= d.n_cnr ? x[c.sig_idx[j - 1]] * cscale : 0.f);
  }
}

template <typename W, bool S64>
__global__ void __launch_bounds__(THREADS, 1) demod_stage(Dims d, Consts c, LinkIO io) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TileIdx t(d.batch);
  float* o = reinterpret_cast<float*>(smem);
  gauss_tile<W, S64>(smem, Act{io.y, 2 * d.n, d.n, d.n}, static_cast<const W*>(c.bfd_g), d.n,
                t.row0, t.rows, t.col0, o);
  const bool last = d.ic_iterations == 0;
  for_tile(t, d.n, [&](int r, int cc, int col) {
    const size_t row = t.row0 + r;
    const float vr = o[r * LDO + cc], vi = o[(BM + r) * LDO + cc];
    float* d0 = io.d0 + row * 2 * d.n;
    d0[col] = vr;
    d0[d.n + col] = vi;
    decide_or_demap(d, c, io, first_q(io), last, row, col, vr, vi);
  });
}

// One-shot common-phase correction of D0 from the decisions Q on the
// unrotated D0 (advanced_receiver_kernel_cc.cc:56-91, JAX fused.py:428-448):
// one warp a burst. phi = the mean over the active symbols of the A&S 4.4.49
// arctan of clip(Im / max(Re, 1e-20), -1, 1) of q conj(d0), then D0 rotated
// by phi in place with Taylor cos / sin. The polynomials are the JAX
// kernel's, not atanf / sincosf, so the kernel and its plain version agree
// to float rounding.
__global__ void __launch_bounds__(256) phase_stage(Dims d, Consts c, LinkIO io,
                                                   const float* q) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * 8 + threadIdx.x / 32;
  if (b >= d.batch) return;  // uniform over the warp
  const int n = d.n;
  const float* qb = q + static_cast<size_t>(b) * 2 * n;
  float* d0 = io.d0 + static_cast<size_t>(b) * 2 * n;
  float part = 0.f;
  for (int col = lane; col < n; col += 32) {
    const float qr = qb[col], qi = qb[n + col];
    const float dr = d0[col], di = d0[n + col];
    const float re = qr * dr + qi * di;
    const float im = qi * dr - qr * di;
    const float u = fminf(fmaxf(im / fmaxf(re, 1e-20f), -1.f), 1.f);
    const float u2 = u * u;
    const float delta = u * (0.9998660f + u2 * (-0.3302995f + u2 * (0.1801410f
                            + u2 * (-0.0851330f + 0.0208351f * u2))));
    part += delta * c.act[col];
  }
  const float p = warp_sum(part) / static_cast<float>(d.n_act), p2 = p * p;
  const float cph = 1.f - p2 * (0.5f - p2 * (1.f / 24.f - p2 / 720.f));
  const float sph = p * (1.f - p2 * (1.f / 6.f - p2 * (1.f / 120.f - p2 / 5040.f)));
  for (int col = lane; col < n; col += 32) {
    const float dr = d0[col], di = d0[n + col];
    d0[col] = cph * dr - sph * di;
    d0[n + col] = sph * dr + cph * di;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    ic_matmul_stage(Dims d, Consts c, LinkIO io, const float* q_in, float* q_out, int last) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TileIdx t(d.batch);
  float* o = reinterpret_cast<float*>(smem);
  // the tile of D0 arrives behind the ring while the product runs
  float* sd0 = reinterpret_cast<float*>(smem + ring_bytes<bf16>());
  const Act d0{io.d0, 2 * d.n, d.n, d.n};
  const bool staged = d0.vec();
  if (staged) {
    load_rows<BN>(sd0, LDO, d0, t.row0, t.rows, t.col0, true);
    cp_commit();
  }
  gauss_tile<bf16>(smem, Act{q_in, 2 * d.n, d.n, d.n}, reinterpret_cast<const bf16*>(c.icop), d.n,
                   t.row0, t.rows, t.col0, o);
  for_tile(t, d.n, [&](int r, int cc, int col) {
    const size_t row = t.row0 + r;
    const float* g = io.d0 + row * 2 * d.n;
    const float dr = staged ? sd0[r * LDO + cc] : g[col];
    const float di = staged ? sd0[(BM + r) * LDO + cc] : g[d.n + col];
    decide_or_demap(d, c, io, q_out, last, row, col, dr - o[r * LDO + cc],
                    di - o[(BM + r) * LDO + cc]);
  });
}

// One burst a CTA: neighbour subcarriers k-1, k+1 (mod K), then the M-tap
// circulant within the M-block (tap j multiplies timeslot (m - j) mod M).
__global__ void __launch_bounds__(256)
    ic_conv_stage(Dims d, Consts c, LinkIO io, const float* q_in, float* q_out, int last) {
  extern __shared__ float sq[];  // the burst's decisions [re | im]
  const int n = d.n, M = d.timeslots, K = d.subcarriers;
  const size_t row = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) sq[i] = q_in[row * 2 * n + i];
  __syncthreads();
  const float* d0 = io.d0 + row * 2 * n;
  for (int col = threadIdx.x; col < n; col += blockDim.x) {
    const int k = col / M, m = col - k * M;
    const int lo = ((k + K - 1) % K) * M, hi = ((k + 1) % K) * M;
    float ir = 0.f, ii = 0.f;
    for (int j = 0; j < M; ++j) {
      int mm = m - j;
      if (mm < 0) mm += M;
      const float sr = sq[lo + mm] + sq[hi + mm];
      const float si = sq[n + lo + mm] + sq[n + hi + mm];
      const float tr = c.taps[j], ti = c.taps[M + j];
      ir = ir + tr * sr - ti * si;
      ii = ii + tr * si + ti * sr;
    }
    decide_or_demap(d, c, io, q_out, last, row, col, d0[col] - ir, d0[n + col] - ii);
  }
}

// x -> (hi, lo) as the 3xTF32 products split their operands
__global__ void tf32_split_kernel(int n, const float* x, float* hi, float* lo) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const float2 s = tf32_split(x[i]);
    hi[i] = s.x;
    lo[i] = s.y;
  }
}

template <typename... P, typename... A>
int launch(void (*kernel)(P...), dim3 grid, int threads, size_t smem, cudaStream_t st,
           A... args) {
  (void)cudaGetLastError();  // report this launch's error only (earlier calls reported theirs)
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      (void)cudaGetLastError();  // a refused launch leaves no error behind
      return static_cast<int>(err);
    }
  }
  kernel<<<grid, threads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

inline int tiles(int n, int t) { return (n + t - 1) / t; }

// S64: the dense receiver's float32 stacks, every product summed in float64
template <typename W, bool S64 = false>
int product_stage(int stage, const Dims& d, const Consts& c, const LinkIO& io,
                  cudaStream_t st) {
  const dim3 grid(tiles(d.n, BN), tiles(d.batch, BM));
  const size_t smem = ring_bytes<W>();
  switch (stage) {
    case TX:
      return launch(tx_stage<W>, grid, THREADS, smem, st, d, c, io);
    case EST_ZF:
      return launch(est_zf_stage<W, S64>, grid, THREADS, smem + OUT_BYTES, st, d, c, io);
    case PRE_DFT:
      return launch(pre_dft_stage<W, S64>, dim3(tiles(d.half, BN), grid.y), THREADS, smem, st,
                    d, c, io);
    case DEMOD:
      return launch(demod_stage<W, S64>, grid, THREADS, smem, st, d, c, io);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int link_stage(const Dims& d, const Consts& c, const LinkIO& io, int stage, int it,
               cudaStream_t st) {
  if (tiles(d.batch, BM) > 65535) return static_cast<int>(cudaErrorInvalidValue);
  float* const q0 = first_q(io);
  if (stage == METRICS) {
    return launch(metrics_stage, dim3(tiles(d.batch, 8)), 256, 0, st, d, c, io);
  }
  if (stage == PHASE) {
    if (!d.phase_comp || d.ic_iterations == 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch(phase_stage, dim3(tiles(d.batch, 8)), 256, 0, st, d, c, io,
                  static_cast<const float*>(q0));
  }
  if (stage == IC) {
    if (it < 0 || it >= d.ic_iterations) return static_cast<int>(cudaErrorInvalidValue);
    // the demod stage's decisions sit in q0; each iteration reads the
    // buffer the previous one wrote and writes the other
    const float* q_in = it % 2 == 0 ? q0 : io.y;
    float* q_out = it % 2 == 0 ? io.y : q0;
    const int last = it == d.ic_iterations - 1;
    if (d.ic_mode == 1) {
      return launch(ic_matmul_stage, dim3(tiles(d.n, BN), tiles(d.batch, BM)), THREADS,
                    ring_bytes<bf16>() + OUT_BYTES, st, d, c, io, q_in, q_out, last);
    }
    return launch(ic_conv_stage, dim3(d.batch), 256, sizeof(float) * 2 * d.n, st, d, c, io,
                  q_in, q_out, last);
  }
  if (d.sum64) {
    return d.bf16 ? static_cast<int>(cudaErrorInvalidValue)
                  : product_stage<float, true>(stage, d, c, io, st);
  }
  return d.bf16 ? product_stage<bf16>(stage, d, c, io, st)
                : product_stage<float>(stage, d, c, io, st);
}

}  // namespace lg
}  // namespace gfdm

// One launch of stage `stage` (gfdm::lg::Stage; `it` the IC iteration) on
// `stream`. The wrappers (kernels/fused.py::_link_single_cuda,
// _rx_receiver_cuda) run their plan's stages in order on one stream.
extern "C" int gfdm_link_stage(const gfdm::Dims* d, const gfdm::Consts* c,
                               const gfdm::lg::LinkIO* io, int stage, int it, void* stream) {
  if (d->batch <= 0) return 0;
  return gfdm::lg::link_stage(*d, *c, *io, stage, it, static_cast<cudaStream_t>(stream));
}

extern "C" int gfdm_tf32_split(int n, const float* x, float* hi, float* lo, void* stream) {
  if (n <= 0) return 0;
  (void)cudaGetLastError();  // report this launch's error only
  gfdm::lg::tf32_split_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      n, x, hi, lo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gfdm_link_io_size() { return static_cast<int>(sizeof(gfdm::lg::LinkIO)); }

extern "C" const char* gfdm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The library's own CUDA runtime (cudart is linked in statically, apart
// from PyTorch's, and exports no symbol): its last error, read without
// clearing it, and its cudaSetDevice. tests/test_torch_gpu.py leaves an
// error there (an ordinal no card has) and checks that each launcher
// reports its own launch only.
extern "C" int gfdm_peek_error() { return static_cast<int>(cudaPeekAtLastError()); }

extern "C" int gfdm_set_device(int dev) { return static_cast<int>(cudaSetDevice(dev)); }

extern "C" int gfdm_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(gfdm::Dims));
  out[1] = static_cast<int>(sizeof(gfdm::Consts));
  return 0;
}
