// Shared device code of the fused GFDM kernels (tx.cu, rx.cu, link.cu).
//
// Layouts follow the planar convention of the Python package: a complex
// row of length n is the real row [re | im] of length 2n; a complex operator
// W (n_in, n_out) is the Gauss stack [Wr; Wi; Wr+Wi] of shape (3 n_in, n_out),
// row-major. One CTA takes a tile of TB bursts (a template parameter: the
// receiver picks 8, 4, 2 or 1 by what fits in shared memory, rx_tile_bursts);
// the tile's activations live in shared memory and each thread owns two
// adjacent output columns for all TB bursts of the tile (fp32 FMA
// accumulation in registers). The operator stacks are read straight from
// global memory; at the canonical config they total about 14 MB and stay
// resident in the 50 MB L2.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gfdm {

constexpr int MAX_THREADS = 512;  // launch bound: at most 128 registers a thread

// Sizes of one call. Field order mirrors kernels/cuda_lib.py::Dims.
struct Dims {
  int batch;          // B, any value >= 0 (the last tile is masked)
  int n;              // N = M * K
  int n_data;         // payload symbols per burst
  int timeslots;      // M
  int subcarriers;    // K
  int half;           // 2K, complex preamble length
  int frame_len;      // burst length per plane
  int preamble_len;
  int cp_len;
  int cs_len;
  int shift;          // cyclic shift of the Tx chain
  int n_cnr;          // CNR count (= number of signal / noise bins)
  int met_w;          // metrics row width [snr | cnrs | 0-pad]
  int ic_iterations;
  int ic_mode;        // 0: circulant convolution, 1: bf16 operator matmul
};

// Device pointers of the constants. Field order mirrors cuda_lib.py::Consts.
struct Consts {
  const float* t_g;        // (3 n_data, N) payload -> core frame
  const float* win;        // (N + cp + cs) CP/CS window
  const float* pre;        // (2, preamble_len) preamble of this shift
  const float* e_g;        // (3 * 2K, N) channel estimator
  const float* f_g;        // (3N, N) N-point DFT
  const float* bfd_g;      // (3N, N) FD demodulator
  const float* f2_g;       // (3 * 2K, 2K) 2K-point DFT
  const float* act;        // (N) 1 on active subcarriers' symbols, else 0
  const int* sig_idx;      // (n_cnr) signal bins of the preamble DFT
  const int* noise_idx;    // (n_cnr) noise bins of the preamble DFT
  const int* demap_idx;    // (n_data) frame position of each data symbol
  const float* taps;       // (2, M) circulant IC taps, amplitude folded in
  const uint16_t* icop;    // (3N, N) bf16 bits of the IC operator
};

__device__ __forceinline__ float load_w(const float* p) { return __ldg(p); }

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32 bits
__device__ __forceinline__ float load_w(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

// Complex product of the TB rows held in shared memory with a Gauss stack:
//   P1 = xr @ Wr,  P2 = xi @ Wi,  P3 = (xr + xi) @ (Wr + Wi)
//   yr = P1 - P2,  yi = P3 - P1 - P2
// Row b's real part is xr[b * ldx + k], its imaginary part xi[b * ldx + k].
// epi(b, col, yr, yi) runs for every tile row b < TB and column col < n_out;
// rows past the batch hold zeros or finite garbage and the epilogue drops
// their global writes. Reads only shared x and global g: the caller
// synchronises before x changes.
template <int TB, typename W, typename Epi>
__device__ __forceinline__ void gauss_gemm(const float* xr, const float* xi,
                                           int ldx, const W* __restrict__ g,
                                           int n_in, int n_out, Epi epi) {
  const size_t plane = static_cast<size_t>(n_in) * n_out;
  for (int c0 = 2 * threadIdx.x; c0 < n_out; c0 += 2 * blockDim.x) {
    const bool two = c0 + 1 < n_out;
    float p1[TB][2], p2[TB][2], p3[TB][2];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      p1[b][0] = p1[b][1] = 0.f;
      p2[b][0] = p2[b][1] = 0.f;
      p3[b][0] = p3[b][1] = 0.f;
    }
    const W* g1 = g + c0;
    const W* g2 = g1 + plane;
    const W* g3 = g2 + plane;
#pragma unroll 2
    for (int k = 0; k < n_in; ++k) {
      const size_t off = static_cast<size_t>(k) * n_out;
      const float w1a = load_w(g1 + off), w2a = load_w(g2 + off), w3a = load_w(g3 + off);
      const float w1b = two ? load_w(g1 + off + 1) : 0.f;
      const float w2b = two ? load_w(g2 + off + 1) : 0.f;
      const float w3b = two ? load_w(g3 + off + 1) : 0.f;
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        const float a = xr[b * ldx + k];
        const float c = xi[b * ldx + k];
        const float s = a + c;
        p1[b][0] = fmaf(a, w1a, p1[b][0]);
        p1[b][1] = fmaf(a, w1b, p1[b][1]);
        p2[b][0] = fmaf(c, w2a, p2[b][0]);
        p2[b][1] = fmaf(c, w2b, p2[b][1]);
        p3[b][0] = fmaf(s, w3a, p3[b][0]);
        p3[b][1] = fmaf(s, w3b, p3[b][1]);
      }
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      epi(b, c0, p1[b][0] - p2[b][0], p3[b][0] - p1[b][0] - p2[b][0]);
      if (two) epi(b, c0 + 1, p1[b][1] - p2[b][1], p3[b][1] - p1[b][1] - p2[b][1]);
    }
  }
}

// Shared-memory floats of one receiver tile of tb bursts: preamble P
// (tb x 2 x 2K), then four N-wide planar stages F, C, X, D0 (tb x 2N each),
// then 2 x tb scalars.
__host__ __device__ inline size_t rx_smem_floats(const Dims& d, int tb) {
  return static_cast<size_t>(tb) * (2 * d.half + 4 * 2 * d.n) + 2 * tb;
}

// Bursts a receiver CTA takes: the largest of 8, 4, 2, 1 whose tile fits the
// current device's opt-in shared memory (8 at the canonical config, 4 at
// K = 128, 2 at K = 256, 1 at K = 512); 0 when not even one burst fits.
inline int rx_tile_bursts(const Dims& d) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  for (int tb = 8; tb >= 1; tb /= 2) {
    if (sizeof(float) * rx_smem_floats(d, tb) <= static_cast<size_t>(optin)) return tb;
  }
  return 0;
}

// Threads of a CTA: two output columns each over the widest GEMM (N wide).
inline int block_threads(const Dims& d) {
  int t = ((d.n + 1) / 2 + 31) / 32 * 32;
  if (t < 64) t = 64;
  return t > MAX_THREADS ? MAX_THREADS : t;
}

// Payload tile (TB x 2 n_data in shared memory) -> core frame; epi(b, col,
// core_re, core_im) places each core sample.
template <int TB, typename Epi>
__device__ __forceinline__ void tx_core(const Dims& d, const Consts& c,
                                        const float* data, Epi epi) {
  gauss_gemm<TB>(data, data + d.n_data, 2 * d.n_data, c.t_g, d.n_data, d.n, epi);
}

// Copies rows [b0, b0 + nb) of a (B, 2 * len) global array into a TB-row
// shared tile with row stride 2 * len; rows past nb become zeros.
template <int TB>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int len,
                                          int nb) {
  const int w = 2 * len;
  for (int i = threadIdx.x; i < TB * w; i += blockDim.x) {
    const int b = i / w;
    dst[i] = b < nb ? src[static_cast<size_t>(b) * w + (i - b * w)] : 0.f;
  }
}

// The receiver on a tile whose preamble window P (TB x [re | im] of 2K) and
// payload block F (TB x [re | im] of N) are in shared memory:
//   channel estimate C = P @ E; SNR/CNR from |P @ F2|^2 over the signal and
//   noise bins; Y = ZF(F @ DFT, C) with |C|^2 clamped at 1e-30;
//   D0 = Y @ Bfd; ic_iterations of: QPSK decisions (+-1 on active symbols,
//   else 0) -> interference -> D = D0 - interference.
// Writes chan (if not null) and met rows [snr | cnrs | 0-pad] for b < nb;
// returns the shared-memory row block (TB x 2N) holding the symbols.
template <int TB>
__device__ inline const float* rx_chain(const Dims& d, const Consts& c,
                                        float* smem, int nb, float* chan_out,
                                        float* met_out) {
  const int n = d.n, half = d.half, w = 2 * n;
  float* P = smem;
  float* F = P + TB * 2 * half;
  float* C = F + TB * w;
  float* X = C + TB * w;
  float* D0 = X + TB * w;
  float* snr = D0 + TB * w;  // (TB) snr_lin
  float* cscale = snr + TB;  // (TB) snr_lin / (sig / n_cnr)

  // 1. channel estimate
  gauss_gemm<TB>(P, P + half, 2 * half, c.e_g, half, n,
             [&](int b, int col, float yr, float yi) {
               C[b * w + col] = yr;
               C[b * w + n + col] = yi;
               if (chan_out != nullptr && b < nb) {
                 chan_out[static_cast<size_t>(b) * w + col] = yr;
                 chan_out[static_cast<size_t>(b) * w + n + col] = yi;
               }
             });
  // 2. preamble power spectrum, into X as scratch
  gauss_gemm<TB>(P, P + half, 2 * half, c.f2_g, half, half,
             [&](int b, int col, float yr, float yi) {
               X[b * half + col] = yr * yr + yi * yi;
             });
  __syncthreads();
  // 3. SNR / CNR metrics (index sums in place of the selection matmul)
  for (int b = threadIdx.x; b < TB; b += blockDim.x) {
    float sig = 0.f, noise = 0.f;
    for (int j = 0; j < d.n_cnr; ++j) {
      sig += X[b * half + c.sig_idx[j]];
      noise += X[b * half + c.noise_idx[j]];
    }
    const float s = (sig - noise) / noise;
    snr[b] = s;
    cscale[b] = s / (sig / static_cast<float>(d.n_cnr));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb * d.met_w; i += blockDim.x) {
    const int b = i / d.met_w, j = i - b * d.met_w;
    float v = 0.f;
    if (j == 0) {
      v = snr[b];
    } else if (j <= d.n_cnr) {
      v = X[b * half + c.sig_idx[j - 1]] * cscale[b];
    }
    met_out[static_cast<size_t>(b) * d.met_w + j] = v;
  }
  __syncthreads();
  // 4. block DFT + ZF divide, into X
  gauss_gemm<TB>(F, F + n, w, c.f_g, n, n,
             [&](int b, int col, float xr, float xi) {
               const float hr = C[b * w + col], hi = C[b * w + n + col];
               const float den = fmaxf(hr * hr + hi * hi, 1e-30f);
               X[b * w + col] = (xr * hr + xi * hi) / den;
               X[b * w + n + col] = (xi * hr - xr * hi) / den;
             });
  __syncthreads();
  // 5. FD demodulation, into D0
  gauss_gemm<TB>(X, X + n, w, c.bfd_g, n, n,
             [&](int b, int col, float yr, float yi) {
               D0[b * w + col] = yr;
               D0[b * w + n + col] = yi;
             });
  __syncthreads();
  // 6. interference cancellation: decisions Q in X, state D in F
  const float* cur = D0;
  float* Q = X;
  float* D = F;
  const int M = d.timeslots, K = d.subcarriers;
  for (int it = 0; it < d.ic_iterations; ++it) {
    for (int i = threadIdx.x; i < TB * w; i += blockDim.x) {
      const int col = i % n;
      Q[i] = (cur[i] >= 0.f ? 1.f : -1.f) * c.act[col];
    }
    __syncthreads();
    if (d.ic_mode == 1) {
      gauss_gemm<TB>(Q, Q + n, w, c.icop, n, n,
                 [&](int b, int col, float ir, float ii) {
                   D[b * w + col] = D0[b * w + col] - ir;
                   D[b * w + n + col] = D0[b * w + n + col] - ii;
                 });
    } else {
      // neighbour subcarriers k-1, k+1 (mod K), then the M-tap circulant
      // within the M-block: tap j multiplies timeslot (m - j) mod M
      for (int i = threadIdx.x; i < TB * n; i += blockDim.x) {
        const int b = i / n, col = i - b * n;
        const int k = col / M, m = col - k * M;
        const float* qr = Q + b * w;
        const float* qi = qr + n;
        const int lo = ((k + K - 1) % K) * M, hi = ((k + 1) % K) * M;
        float ir = 0.f, ii = 0.f;
        for (int j = 0; j < M; ++j) {
          int mm = m - j;
          if (mm < 0) mm += M;
          const float sr = qr[lo + mm] + qr[hi + mm];
          const float si = qi[lo + mm] + qi[hi + mm];
          const float tr = c.taps[j], ti = c.taps[M + j];
          ir = ir + tr * sr - ti * si;
          ii = ii + tr * si + ti * sr;
        }
        D[b * w + col] = D0[b * w + col] - ir;
        D[b * w + n + col] = D0[b * w + n + col] - ii;
      }
    }
    __syncthreads();
    cur = D;
  }
  return cur;
}

}  // namespace gfdm
