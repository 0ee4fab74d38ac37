// Shared device code of the GFDM kernels (rx.cu, link.cu, factored.cu; tx.cu
// takes Dims and Consts only).
//
// Layouts follow the planar convention of the Python package: a complex
// row of length n is the real row [re | im] of length 2n; a complex operator
// W (n_in, n_out) is the Gauss stack [Wr; Wi; Wr+Wi] of shape (3 n_in, n_out),
// row-major, in float32 or (the link's dtype "bfloat16") as bf16 bits. One
// CTA takes a tile of TB bursts (a template parameter: the superseded
// receivers pick 8, 4, 2 or 1 by what fits in shared memory,
// rx_tile_bursts); the tile's
// activations live in shared memory and each thread owns two adjacent output
// columns for all TB bursts of the tile (fp32 FMA accumulation in
// registers). The operator stacks are read straight from global memory; at
// the canonical config they total about 14 MB and stay resident in the 50 MB
// L2.
//
// The staged receiver's and link's options are runtime fields of Dims read
// by link.cu's stages; the superseded receivers here run ZF and circulant
// QPSK IC. What changes an inner loop is a template parameter: the tile
// TB, the stacks' element type W and, with bf16 stacks, the rounding of
// each activation to bf16 (RND).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gfdm {

constexpr int MAX_THREADS = 512;  // launch bound: at most 128 registers a thread

// Sizes and options of one call. Field order mirrors kernels/cuda_lib.py::Dims.
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
  int n_ports;        // Tx ports written from one core (CDD); shifts in Consts
  int n_cnr;          // CNR count (= number of signal / noise bins)
  int met_w;          // metrics row width [snr | cnrs | 0-pad]
  int ic_iterations;
  int ic_mode;        // 0: circulant convolution, 1: bf16 operator matmul
  int dec_kind;       // IC decisions: 0 QPSK signs, 1 qam16, 2 qam64 levels
  int equalizer;      // 0 ZF, 1 MMSE (snr), 2 MMSE (per-bin CNR)
  int phase_comp;     // 1: one-shot common-phase correction before the IC
  int n_act;          // active symbols (active subcarriers x M): the phase mean
  int overlap;        // L filter parts (the hybrid receiver's fold)
  int bf16;           // 1: the five Gauss stacks are bf16 (the link only)
  int sum64;          // 1: float32-stack products summed in float64 (the
                      // staged dense receiver)
};

// Device pointers of the constants. Field order mirrors cuda_lib.py::Consts.
struct Consts {
  const void* t_g;         // (3 n_data, N) payload -> core frame
  const float* win;        // (N + cp + cs) CP/CS window
  const float* pre;        // (n_ports, 2, preamble_len) preambles of the ports
  const int* shifts;       // (n_ports) cyclic shift of each Tx port
  const void* e_g;         // (3 * 2K, N) channel estimator
  const void* f_g;         // (3N, N) N-point DFT
  const void* bfd_g;       // (3N, N) FD demodulator
  const void* f2_g;        // (3 * 2K, 2K) 2K-point DFT
  const float* act;        // (N) 1 on active subcarriers' symbols, else 0
  const int* sig_idx;      // (n_cnr) signal bins of the preamble DFT
  const int* noise_idx;    // (n_cnr) noise bins of the preamble DFT
  const int* demap_idx;    // (n_data) frame position of each data symbol
  const float* taps;       // (2, M) circulant IC taps, amplitude folded in
  const uint16_t* icop;    // (3N, N) bf16 bits of the IC operator, amplitude in
  const float* cnri;       // (n_cnr, N) CNR -> per-bin interpolation (mmse_cnr)
  const float* parts;      // (L, 2, M) receive filter parts (hybrid demod)
  const float* ifm;        // (2M, 2M) realified M-point IDFT (hybrid demod)
};

__device__ __forceinline__ float load_w(const float* p) { return __ldg(p); }

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32 bits
__device__ __forceinline__ float load_w(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

// x rounded to bf16 (round to nearest even), back in f32
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename W>
__device__ __forceinline__ const W* stack(const void* p) {
  return static_cast<const W*>(p);
}

// acc + a * b (complex, float2 = (re, im))
__device__ __forceinline__ float2 cmla(float2 acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
  return acc;
}

// Entry (r, c) of the n x n complex map y = x @ W held as its realified
// (2n, 2n) operator: Re W[r, c] at [r, c], Im W[r, c] at [r, n + c].
__device__ __forceinline__ float2 op_entry(const float* w2, int n, int r, int c) {
  const float* row = w2 + static_cast<size_t>(r) * 2 * n;
  return make_float2(__ldg(row + c), __ldg(row + n + c));
}

// Element c of row r of a (rows, 2, n) planar table.
__device__ __forceinline__ float2 planar_at(const float* t, int n, int r, int c) {
  const float* row = t + static_cast<size_t>(r) * 2 * n;
  return make_float2(__ldg(row + c), __ldg(row + n + c));
}

// Complex product of the TB rows held in shared memory with a Gauss stack:
//   P1 = xr @ Wr,  P2 = xi @ Wi,  P3 = (xr + xi) @ (Wr + Wi)
//   yr = P1 - P2,  yi = P3 - P1 - P2
// Row b's real part is xr[b * ldx + k], its imaginary part xi[b * ldx + k].
// RND rounds xr, xi and their sum to bf16 before the products, as the JAX
// package's _gdot casts activations to a bf16 stack's type (f32
// accumulation either way). epi(b, col, yr, yi) runs for every tile row
// b < TB and column col < n_out; rows past the batch hold zeros or finite
// garbage and the epilogue drops their global writes. Reads only shared x
// and global g: the caller synchronises before x changes.
template <int TB, bool RND = false, typename W, typename Epi>
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
        float a = xr[b * ldx + k];
        float c = xi[b * ldx + k];
        float s;
        if constexpr (RND) {
          a = bf16_round(a);
          c = bf16_round(c);
          s = bf16_round(a + c);
        } else {
          s = a + c;
        }
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

// gauss_gemm over one of the five stacks of Consts, held as W (float, or
// bf16 bits rounding the activations as well)
template <int TB, typename W, typename Epi>
__device__ __forceinline__ void stack_gemm(const float* xr, const float* xi, int ldx,
                                           const void* g, int n_in, int n_out, Epi epi) {
  constexpr bool kBf16 = sizeof(W) == 2;
  gauss_gemm<TB, kBf16>(xr, xi, ldx, stack<W>(g), n_in, n_out, epi);
}

// Shared-memory floats of one receiver tile of tb bursts: preamble P
// (tb x 2 x 2K), then four N-wide planar stages F, C, X, D0 (tb x 2N each).
__host__ __device__ inline size_t rx_smem_floats(const Dims& d, int tb) {
  return static_cast<size_t>(tb) * (2 * d.half + 4 * 2 * d.n);
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

// The receiver tile's shared memory (rx_smem_floats).
template <int TB>
struct RxTile {
  float* P;       // (TB, 2, 2K) preamble window
  float* F;       // (TB, 2N) payload block; later fold / IC state / scratch
  float* C;       // (TB, 2N) channel
  float* X;       // (TB, 2N) preamble power, then DFT + ZF; later decisions
  float* D0;      // (TB, 2N) demodulated symbols
  __device__ RxTile(const Dims& d, float* smem) {
    const int w = 2 * d.n;
    P = smem;
    F = P + TB * 2 * d.half;
    C = F + TB * w;
    X = C + TB * w;
    D0 = X + TB * w;
  }
};

// Channel estimate C = P @ E; also written to chan_out (if not null) for b < nb.
template <int TB, typename W>
__device__ inline void estimate_channel(const Dims& d, const Consts& c,
                                        const RxTile<TB>& t, int nb, float* chan_out) {
  const int n = d.n, w = 2 * n, half = d.half;
  stack_gemm<TB, W>(t.P, t.P + half, 2 * half, c.e_g, half, n,
                    [&](int b, int col, float yr, float yi) {
                      t.C[b * w + col] = yr;
                      t.C[b * w + n + col] = yi;
                      if (chan_out != nullptr && b < nb) {
                        chan_out[static_cast<size_t>(b) * w + col] = yr;
                        chan_out[static_cast<size_t>(b) * w + n + col] = yi;
                      }
                    });
}

// Block DFT of F and ZF divide by C (|C|^2 clamped at 1e-30) into X. Ends
// on a barrier.
template <int TB, typename W>
__device__ inline void dft_zf(const Dims& d, const Consts& c, const RxTile<TB>& t) {
  const int n = d.n, w = 2 * n;
  stack_gemm<TB, W>(t.F, t.F + n, w, c.f_g, n, n,
                    [&](int b, int col, float xr, float xi) {
                      const float hr = t.C[b * w + col], hi = t.C[b * w + n + col];
                      const float den = fmaxf(hr * hr + hi * hi, 1e-30f);
                      t.X[b * w + col] = (xr * hr + xi * hi) / den;
                      t.X[b * w + n + col] = (xi * hr - xr * hi) / den;
                    });
  __syncthreads();
}

// FD demodulation X @ Bfd into D0. Ends on a barrier.
template <int TB, typename W>
__device__ inline void demod_dense(const Dims& d, const Consts& c, const RxTile<TB>& t) {
  const int n = d.n, w = 2 * n;
  stack_gemm<TB, W>(t.X, t.X + n, w, c.bfd_g, n, n,
                    [&](int b, int col, float yr, float yi) {
                      t.D0[b * w + col] = yr;
                      t.D0[b * w + n + col] = yi;
                    });
  __syncthreads();
}

// The hybrid demodulator in place of the Bfd product: the L-tap fold of the
// natural-order spectrum X into F,
//   S[k M + m] = sum_i parts[(i + L/2) % L][m] X[((k + i - L/2) mod K) M + m],
// then the per-subcarrier M-point IDFTs into D0,
//   d0[k M + m] = sum_j iFM[m, j] S[k M + j].
// Ends on a barrier.
template <int TB>
__device__ inline void demod_hybrid(const Dims& d, const Consts& c, const RxTile<TB>& t) {
  const int n = d.n, w = 2 * n, M = d.timeslots, K = d.subcarriers, L = d.overlap;
  for (int i = threadIdx.x; i < TB * n; i += blockDim.x) {
    const int b = i / n, col = i - b * n;
    const int k = col / M, m = col - k * M;
    const float* y = t.X + b * w;
    float2 s = make_float2(0.f, 0.f);
    for (int l = 0; l < L; ++l) {
      int kk = k + l - L / 2;
      kk = kk < 0 ? kk + K : (kk >= K ? kk - K : kk);
      s = cmla(s, make_float2(y[kk * M + m], y[n + kk * M + m]),
               planar_at(c.parts, M, (l + L / 2) % L, m));
    }
    t.F[b * w + col] = s.x;
    t.F[b * w + n + col] = s.y;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TB * n; i += blockDim.x) {
    const int b = i / n, col = i - b * n;
    const int k = col / M, m = col - k * M;
    const float* s = t.F + b * w + k * M;
    float2 x = make_float2(0.f, 0.f);
    for (int j = 0; j < M; ++j) x = cmla(x, make_float2(s[j], s[n + j]), op_entry(c.ifm, M, j, m));
    t.D0[b * w + col] = x.x;
    t.D0[b * w + n + col] = x.y;
  }
  __syncthreads();
}

// IC decision level of u (the amplitude is folded into the taps / operator):
// QPSK: >= 0 -> +1, else -1; qam16 / qam64: the odd level nearest to
// u * scale, clip(2 rint((u * scale - 1) / 2) + 1, -lim, lim). rintf rounds
// half to even like jnp.round / torch.round; the _rn intrinsics keep the
// compiler from contracting u * scale - 1 into one FMA.
__device__ __forceinline__ float ic_level(float u, int kind) {
  if (kind == 0) return u >= 0.f ? 1.f : -1.f;
  const float scale = kind == 1 ? 3.16227766016837952f : 6.48074069840786023f;
  const float lim = kind == 1 ? 3.f : 7.f;
  const float v = __fsub_rn(__fmul_rn(u, scale), 1.f) / 2.f;
  return fminf(fmaxf(2.f * rintf(v) + 1.f, -lim), lim);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Decision-directed interference cancellation from D0: ic_iterations of
// Q = level(D) on active symbols (0 elsewhere) -> the circulant
// interference -> D = D0 - interference, the first iteration deciding on
// D0. Decisions live in X, the state in F. Returns the rows holding the
// symbols.
template <int TB>
__device__ inline const float* cancel_interference(const Dims& d, const Consts& c,
                                                   const RxTile<TB>& t) {
  const int n = d.n, w = 2 * n, M = d.timeslots, K = d.subcarriers;
  const float* cur = t.D0;
  float* Q = t.X;
  float* D = t.F;
  for (int it = 0; it < d.ic_iterations; ++it) {
    for (int i = threadIdx.x; i < TB * w; i += blockDim.x) {
      const int col = i % n;
      Q[i] = ic_level(cur[i], d.dec_kind) * c.act[col];
    }
    __syncthreads();
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
      D[b * w + col] = t.D0[b * w + col] - ir;
      D[b * w + n + col] = t.D0[b * w + n + col] - ii;
    }
    __syncthreads();
    cur = D;
  }
  return cur;
}

}  // namespace gfdm
