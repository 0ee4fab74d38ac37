// Factored GFDM kernels for Hopper (sm_90a): the large-K transmitter and
// receiver, with no dense operator of any kind on the demodulation path.
//
// Replaces the Pallas kernels gfdm_tpu/kernels/fused.py::_tx_factored_kernel
// (wrapper tx_frame_factored), ::_rx_factored_kernel (rx_receiver_factored,
// estimator="fused") and ::_rx_factored_chan_kernel (estimator="fast"); the
// two receivers are the two instantiations of one template, so they cannot
// drift apart.
//
// Receiver, per burst (N = K M; payload sample t = M n2 + n1):
//   Z[n1, k2]    = sum_n2 x[M n2 + n1] W_K^(n2 k2)                K-point DFTs
//   X[k1 K + k2] = sum_n1 FM[n1, k1] tw[n1, k2] Z[n1, k2]         M-point stage
//   Y            = X conj(H) / max(|H|^2, 1e-30)                  ZF
//   S[k M + m]   = sum_i parts[(i + L/2) % L][m] Y[((k + i - L/2) mod K) M + m]
//   d0[k M + m]  = sum_n iFM[n, m] S[k M + n]                     M-point IFFTs
//   d            = d0 - sum_j taps[j] (q[k-1, m-j] + q[k+1, m-j])   (ic_iterations)
// with q = +-1 (>= 0 -> +1) on active symbols and 0 elsewhere; H comes from
// the dense (4K, 2N) estimator (CHAN_IN false) or is read (CHAN_IN true).
// The transmitter runs the same stages reversed: resource map, per-subcarrier
// M-point DFTs, L-tap overlap-add, the M-point stage of the N-point IDFT with
// the conjugate twiddles, K-point IDFTs; then CP/CS at the cyclic shift,
// window and preamble.
//
// Bound: the K-point DFTs, M K^2 complex MACs a burst (9.4 M fp32 FMAs at
// K = 512, against 37 KB read and 37 KB written a burst): FMA and
// shared-memory-load bound. Every other stage is O(N M) or O(N L).
// Design: one CTA a burst. The burst's N-sample stages (two for the Tx, three
// for the receiver; 72 KB each at K = 1024) and a K-entry twiddle table live
// in shared memory as interleaved complex, so the chain reads the burst once
// and writes its outputs once. The DFT takes W^(j k) from the table at
// (j k mod K) where the Pallas kernel multiplies by a dense (2K, 2K) matrix
// (16 MB at K = 1024), and the Pallas kernel's rolls, masks, coefficient rows
// and reorder gathers are index arithmetic. The constants are planar_fast's:
// the realified K- and M-point operators (the twiddle table is row 1 of the
// K-point one), the (M, 2, K) twiddles and the (L, 2, M) filter parts.
#include "gfdm_common.cuh"  // cmla, op_entry, planar_at

namespace gfdm {

constexpr int FAC_MAX_THREADS = 512;
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
  const float* e_w;     // (4K, 2N) realified channel estimator (CHAN_IN false)
};

enum FactoredKind { kTx = 0, kRxEstimate = 1, kRxChanIn = 2 };

// Shared memory of one CTA: the twiddle table (K), the N-sample stages and,
// for the in-kernel estimator, the 2K-sample preamble window.
__host__ __device__ inline size_t factored_smem_bytes(const FactoredDims& d,
                                                      int kind) {
  const size_t K = d.subcarriers, n = d.n;
  const size_t c = K + (kind == kTx ? 2 : 3) * n + (kind == kRxEstimate ? 2 * K : 0);
  return c * sizeof(float2);
}

// Threads of a CTA: one per (row group, DFT bin) of the K-point stage.
inline int factored_threads(const FactoredDims& d) {
  const int groups = (d.timeslots + FAC_ROWS - 1) / FAC_ROWS;
  int t = (groups * d.subcarriers + 31) / 32 * 32;
  if (t < 64) t = 64;
  return t > FAC_MAX_THREADS ? FAC_MAX_THREADS : t;
}

// K-point DFTs of the M rows of `in` (M x K in shared memory):
// out(r, k) = sum_j in[r K + j] wk[(j k) mod K]; epi(r, k, value) places each.
// A thread takes FAC_ROWS rows of one bin, so each twiddle load feeds them
// all; the rows are broadcast loads within a warp.
template <typename Epi>
__device__ __forceinline__ void dft_rows(const float2* in, const float2* wk,
                                         int K, int M, Epi epi) {
  const int groups = (M + FAC_ROWS - 1) / FAC_ROWS;
  for (int item = threadIdx.x; item < groups * K; item += blockDim.x) {
    const int g = item / K, k = item - g * K, r0 = g * FAC_ROWS;
    const float2* rows[FAC_ROWS];
    float2 acc[FAC_ROWS];
#pragma unroll
    for (int r = 0; r < FAC_ROWS; ++r) {
      rows[r] = in + min(r0 + r, M - 1) * K;  // rows past M repeat the last
      acc[r] = make_float2(0.f, 0.f);
    }
    int idx = 0;  // (j k) mod K
    for (int j = 0; j < K; ++j) {
      const float2 w = wk[idx];
      idx += k;
      if (idx >= K) idx -= K;
#pragma unroll
      for (int r = 0; r < FAC_ROWS; ++r) acc[r] = cmla(acc[r], rows[r][j], w);
    }
#pragma unroll
    for (int r = 0; r < FAC_ROWS; ++r) {
      if (r0 + r < M) epi(r0 + r, k, acc[r]);
    }
  }
}

template <bool CHAN_IN>
__global__ void __launch_bounds__(FAC_MAX_THREADS)
rx_factored_kernel(FactoredDims d, FactoredConsts c,
                   const float* __restrict__ bursts,
                   const float* __restrict__ chan_in,
                   float* __restrict__ chan_out, float* __restrict__ sym) {
  extern __shared__ float2 fsm[];
  const int K = d.subcarriers, M = d.timeslots, n = d.n, L = d.frame_len;
  const int b = blockIdx.x;
  float2* wk = fsm;    // W_K^t = exp(-2 pi i t / K)
  float2* A = wk + K;  // three N-sample stages
  float2* Bs = A + n;
  float2* C = Bs + n;
  float2* P = C + n;   // preamble window (CHAN_IN false)
  const float* src = bursts + static_cast<size_t>(b) * 2 * L;
  const int fs = d.preamble_len + d.cp_len;
  for (int t = threadIdx.x; t < K; t += blockDim.x) wk[t] = op_entry(c.fk, K, 1, t);
  // payload block, sample t = M n2 + n1 -> A[n1 K + n2] (coalesced reads)
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int n2 = t / M, n1 = t - n2 * M;
    A[n1 * K + n2] = make_float2(src[fs + t], src[L + fs + t]);
  }
  if (!CHAN_IN) {
    for (int t = threadIdx.x; t < 2 * K; t += blockDim.x) {
      P[t] = make_float2(src[d.cp_len + t], src[L + d.cp_len + t]);
    }
  }
  __syncthreads();

  // 1. the channel into C: read, or [pre_re | pre_im] @ E_W (4K, 2N)
  for (int col = threadIdx.x; col < n; col += blockDim.x) {
    float2 h;
    if (CHAN_IN) {
      const float* row = chan_in + static_cast<size_t>(b) * 2 * n;
      h = make_float2(row[col], row[n + col]);
    } else {
      const int K2 = 2 * K;
      float hr = 0.f, hi = 0.f;
      for (int r = 0; r < K2; ++r) {
        const float* er = c.e_w + static_cast<size_t>(r) * 2 * n;
        const float* ei = c.e_w + static_cast<size_t>(K2 + r) * 2 * n;
        const float2 p = P[r];
        hr = fmaf(p.y, __ldg(ei + col), fmaf(p.x, __ldg(er + col), hr));
        hi = fmaf(p.y, __ldg(ei + n + col), fmaf(p.x, __ldg(er + n + col), hi));
      }
      h = make_float2(hr, hi);
      float* row = chan_out + static_cast<size_t>(b) * 2 * n;
      row[col] = hr;
      row[n + col] = hi;
    }
    C[col] = h;
  }
  // 2. K-point DFTs of the M rows: Z -> Bs
  dft_rows(A, wk, K, M, [&](int r, int k, float2 v) { Bs[r * K + k] = v; });
  __syncthreads();

  // 3. twiddle, M-point stage (natural-order spectrum X) and ZF, into C
  for (int k2 = threadIdx.x; k2 < K; k2 += blockDim.x) {
    for (int n1 = 0; n1 < M; ++n1) {
      const float2 z = Bs[n1 * K + k2], t = planar_at(c.tw, K, n1, k2);
      Bs[n1 * K + k2] = make_float2(z.x * t.x - z.y * t.y, z.x * t.y + z.y * t.x);
    }
    for (int k1 = 0; k1 < M; ++k1) {
      float2 x = make_float2(0.f, 0.f);
      for (int n1 = 0; n1 < M; ++n1) {
        x = cmla(x, Bs[n1 * K + k2], op_entry(c.fm, M, n1, k1));
      }
      const int col = k1 * K + k2;
      const float2 h = C[col];
      const float den = fmaxf(h.x * h.x + h.y * h.y, 1e-30f);
      C[col] = make_float2((x.x * h.x + x.y * h.y) / den, (x.y * h.x - x.x * h.y) / den);
    }
  }
  __syncthreads();

  // 4. fold of the L filter parts, into A
  const int Lo = d.overlap;
  for (int col = threadIdx.x; col < n; col += blockDim.x) {
    const int k = col / M, m = col - k * M;
    float2 s = make_float2(0.f, 0.f);
    for (int i = 0; i < Lo; ++i) {
      int kk = k + i - Lo / 2;
      kk = kk < 0 ? kk + K : (kk >= K ? kk - K : kk);
      s = cmla(s, C[kk * M + m], planar_at(c.parts, M, (i + Lo / 2) % Lo, m));
    }
    A[col] = s;
  }
  __syncthreads();

  // 5. per-subcarrier M-point IFFTs: d0 into Bs
  for (int col = threadIdx.x; col < n; col += blockDim.x) {
    const int k = col / M, m = col - k * M;
    float2 x = make_float2(0.f, 0.f);
    for (int j = 0; j < M; ++j) x = cmla(x, A[k * M + j], op_entry(c.ifm, M, j, m));
    Bs[col] = x;
  }
  __syncthreads();

  // 6. interference cancellation, the state alternating between C and A:
  //    neighbour subcarriers k-1, k+1 (mod K), tap j on timeslot (m - j) mod M
  const float2* cur = Bs;
  float2* nxt = C;
  for (int it = 0; it < d.ic_iterations; ++it) {
    for (int col = threadIdx.x; col < n; col += blockDim.x) {
      const int k = col / M, m = col - k * M;
      const int lo = (k == 0 ? K - 1 : k - 1) * M, hi = (k == K - 1 ? 0 : k + 1) * M;
      float ir = 0.f, ii = 0.f;
      for (int j = 0; j < M; ++j) {
        int mm = m - j;
        if (mm < 0) mm += M;
        const float2 u = cur[lo + mm], v = cur[hi + mm];
        const float au = __ldg(c.act + lo + mm), av = __ldg(c.act + hi + mm);
        const float sr = (u.x >= 0.f ? au : -au) + (v.x >= 0.f ? av : -av);
        const float si = (u.y >= 0.f ? au : -au) + (v.y >= 0.f ? av : -av);
        const float tr = __ldg(c.taps + j), ti = __ldg(c.taps + M + j);
        ir = ir + tr * sr - ti * si;
        ii = ii + tr * si + ti * sr;
      }
      const float2 d0 = Bs[col];
      nxt[col] = make_float2(d0.x - ir, d0.y - ii);
    }
    __syncthreads();
    cur = nxt;
    nxt = nxt == C ? A : C;
  }
  float* out = sym + static_cast<size_t>(b) * 2 * n;
  for (int col = threadIdx.x; col < n; col += blockDim.x) {
    const float2 v = cur[col];
    out[col] = v.x;
    out[n + col] = v.y;
  }
}

__global__ void __launch_bounds__(FAC_MAX_THREADS)
tx_factored_kernel(FactoredDims d, FactoredConsts c,
                   const float* __restrict__ data, float* __restrict__ out) {
  extern __shared__ float2 fsm[];
  const int K = d.subcarriers, M = d.timeslots, n = d.n, n_d = d.n_data;
  const int b = blockIdx.x;
  float2* wk = fsm;    // exp(+2 pi i t / K) / K
  float2* A = wk + K;  // two N-sample stages
  float2* Bs = A + n;
  const float* src = data + static_cast<size_t>(b) * 2 * n_d;
  for (int t = threadIdx.x; t < K; t += blockDim.x) wk[t] = op_entry(c.fk, K, 1, t);
  // resource map: grid position col holds payload symbol map_idx[col]
  for (int col = threadIdx.x; col < n; col += blockDim.x) {
    const int j = __ldg(c.map_idx + col);
    A[col] = j < n_d ? make_float2(src[j], src[n_d + j]) : make_float2(0.f, 0.f);
  }
  __syncthreads();

  // 1. per-subcarrier M-point DFTs, into Bs
  for (int col = threadIdx.x; col < n; col += blockDim.x) {
    const int k = col / M, m = col - k * M;
    float2 x = make_float2(0.f, 0.f);
    for (int j = 0; j < M; ++j) x = cmla(x, A[k * M + j], op_entry(c.fm, M, j, m));
    Bs[col] = x;
  }
  __syncthreads();

  // 2. overlap-add of the L filter parts, into A (natural-order spectrum)
  const int Lo = d.overlap;
  for (int col = threadIdx.x; col < n; col += blockDim.x) {
    const int k = col / M, m = col - k * M;
    float2 s = make_float2(0.f, 0.f);
    for (int i = 0; i < Lo; ++i) {
      int kk = k - i + Lo / 2;
      kk = kk < 0 ? kk + K : (kk >= K ? kk - K : kk);
      s = cmla(s, Bs[kk * M + m], planar_at(c.parts, M, (i + Lo / 2) % Lo, m));
    }
    A[col] = s;
  }
  __syncthreads();

  // 3. M-point stage of the N-point IDFT, then the conjugate twiddle, into Bs
  for (int k2 = threadIdx.x; k2 < K; k2 += blockDim.x) {
    for (int n1 = 0; n1 < M; ++n1) {
      float2 z = make_float2(0.f, 0.f);
      for (int k1 = 0; k1 < M; ++k1) z = cmla(z, A[k1 * K + k2], op_entry(c.ifm, M, k1, n1));
      const float2 t = planar_at(c.tw, K, n1, k2);
      Bs[n1 * K + k2] = make_float2(z.x * t.x - z.y * t.y, z.x * t.y + z.y * t.x);
    }
  }
  __syncthreads();

  // 4. K-point IDFTs: core sample t = M n2 + n1, into A
  dft_rows(Bs, wk, K, M, [&](int r, int k, float2 v) { A[M * k + r] = v; });
  __syncthreads();

  // 5. the burst: preamble, then the windowed core at the CP/CS positions of
  //    the cyclic shift (framed sample j holds core sample (j - cp - shift) mod N)
  const int Lf = d.frame_len, p_len = d.preamble_len, lead = d.cp_len + d.shift;
  float* dst = out + static_cast<size_t>(b) * 2 * Lf;
  for (int i = threadIdx.x; i < 2 * Lf; i += blockDim.x) {
    const int p = i / Lf, t = i - p * Lf;
    float v;
    if (t < p_len) {
      v = __ldg(c.pre + p * p_len + t);
    } else {
      const int j = t - p_len;
      int col = j - lead;
      col = col < 0 ? col + n : (col >= n ? col - n : col);
      const float2 s = A[col];
      v = (p == 0 ? s.x : s.y) * __ldg(c.win + j);
    }
    dst[i] = v;
  }
}

template <bool CHAN_IN>
int launch_rx_factored(const FactoredDims* d, const FactoredConsts* c,
                       const float* bursts, const float* chan_in,
                       float* chan_out, float* sym, void* stream) {
  if (d->batch <= 0) return 0;
  const size_t smem = factored_smem_bytes(*d, CHAN_IN ? kRxChanIn : kRxEstimate);
  cudaError_t err = cudaFuncSetAttribute(
      rx_factored_kernel<CHAN_IN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rx_factored_kernel<CHAN_IN><<<d->batch, factored_threads(*d), smem,
                                static_cast<cudaStream_t>(stream)>>>(
      *d, *c, bursts, chan_in, chan_out, sym);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gfdm

extern "C" int gfdm_tx_factored(const gfdm::FactoredDims* d,
                                const gfdm::FactoredConsts* c, const float* data,
                                float* out, void* stream) {
  if (d->batch <= 0) return 0;
  const size_t smem = gfdm::factored_smem_bytes(*d, gfdm::kTx);
  cudaError_t err = cudaFuncSetAttribute(
      gfdm::tx_factored_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gfdm::tx_factored_kernel<<<d->batch, gfdm::factored_threads(*d), smem,
                             static_cast<cudaStream_t>(stream)>>>(*d, *c, data, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gfdm_rx_factored(const gfdm::FactoredDims* d,
                                const gfdm::FactoredConsts* c, const float* bursts,
                                const float* chan_in, float* chan_out, float* sym,
                                void* stream) {
  return gfdm::launch_rx_factored<false>(d, c, bursts, chan_in, chan_out, sym, stream);
}

extern "C" int gfdm_rx_factored_chan(const gfdm::FactoredDims* d,
                                     const gfdm::FactoredConsts* c,
                                     const float* bursts, const float* chan_in,
                                     float* chan_out, float* sym, void* stream) {
  return gfdm::launch_rx_factored<true>(d, c, bursts, chan_in, chan_out, sym, stream);
}

// kind: 0 the Tx, 1 the receiver with its estimator, 2 with the channel read
extern "C" size_t gfdm_factored_smem_bytes(const gfdm::FactoredDims* d, int kind) {
  return gfdm::factored_smem_bytes(*d, kind);
}

extern "C" int gfdm_factored_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(gfdm::FactoredDims));
  out[1] = static_cast<int>(sizeof(gfdm::FactoredConsts));
  return 0;
}
