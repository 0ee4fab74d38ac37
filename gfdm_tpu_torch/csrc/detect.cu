// Burst-detection front end for Hopper (sm_90a): the whole sync trace
// chain of a chunk batch in one pass.
//
// Replaces the Pallas kernels gfdm_tpu/kernels/detect.py::_kernel (five
// traces; wrapper detect_front_fused) and ::_kernel2 (trace-lean: gated
// metric and ic only; wrapper detect_bursts_fused), as the two
// instantiations of one template. For a (B, 2, T) planar chunk batch with
// complex samples s, per position t:
//   p(t)     = sum_{j<K} conj(s[t+j]) s[t+j+K]      K-lag autocorrelation
//   e(t)     = max(sum_{j<2K} |s[t+j]|^2, 1e-30)     2K energy
//   ac(t)    = 2 p(t) / e(t)
//   ic(t)    = sum_{j=0..cp} |ac|(t-j) / (cp+1)      zeros before the chunk
//   cc(t)    = sum_{j<2K} s[t+j] x_j                 x = conj(preamble)/rms
//   gated(t) = |cc(t)| / 2K * ic(t)                  for t < n_valid
// The front kernel writes ac (B, 2, n_ac), e, ic (B, n_ac) and gated
// (B, n_valid); the lean kernel only gated and ic (B, n_valid).
//
// Bound: per position ~14 fp32 FMAs and 4 shared-memory loads for each of
// the K lags (about 900 FMAs at K = 64) against 8 bytes read and 8 to 20
// bytes written: the FMA pipes and shared-memory loads bound it, not HBM.
// Design: one CTA of TP threads per (chunk, tile of TP positions) stages
// the tile's samples with the cp-sample backward halo and the 2K-1-sample
// forward window, plus the 2K taps, in shared memory (6 KB at the
// canonical config); each thread computes |ac| for one position (the halo
// is recomputed by both neighbouring tiles, cp/TP extra work), then the
// backward CP sum from shared memory. The Pallas kernels' pair rows,
// banded 0/1 matmuls and chunk-boundary mask column become index
// arithmetic and a zero-filled halo, so any chunk count and any T work.
#include <climits>
#include <cuda_runtime.h>

namespace gfdm {

constexpr int DETECT_TP = 256;  // positions (and threads) of a CTA

// Sizes of one call. Field order mirrors kernels/cuda_lib.py::DetectDims.
struct DetectDims {
  int batch;        // B chunks, any value >= 0
  int length;       // T samples a chunk, any value > 2K
  int subcarriers;  // K: autocorrelation lag; the xcorr has 2K taps
  int cp_len;       // the CP integration window is cp_len + 1
  int n_ac;         // T - 2K positions with full windows
  int n_valid;      // min(n_ac, search_limit): positions of the gated metric
};

// Complex samples a CTA stages: its TP positions, the cp halo before them
// and the 2K - 1 samples their windows reach past the tile.
__host__ __device__ inline int detect_span(const DetectDims& d) {
  return DETECT_TP + d.cp_len + 2 * d.subcarriers - 1;
}

// Shared-memory floats of a CTA: taps (2 x 2K), samples (2 x span),
// |ac| (TP + cp), |cc| / 2K (TP).
__host__ __device__ inline size_t detect_smem_floats(const DetectDims& d) {
  return static_cast<size_t>(4 * d.subcarriers + 2 * detect_span(d) +
                             (DETECT_TP + d.cp_len) + DETECT_TP);
}

template <bool LEAN>
__global__ void __launch_bounds__(DETECT_TP)
detect_kernel(DetectDims d, const float* __restrict__ s,
              const float* __restrict__ taps, float* __restrict__ gated,
              float* __restrict__ ac, float* __restrict__ energy,
              float* __restrict__ ic) {
  extern __shared__ float sm[];
  const int K = d.subcarriers, w = 2 * K, cp = d.cp_len, T = d.length;
  const int n_out = LEAN ? d.n_valid : d.n_ac;  // positions of ic written
  const int tiles = (n_out + DETECT_TP - 1) / DETECT_TP;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * DETECT_TP;
  const int q0 = t0 - cp;  // position of mag[0]
  const int span = detect_span(d);
  float* tr = sm;  // taps, re then im
  float* ti = tr + w;
  float* sr = ti + w;  // samples [q0, q0 + span), zero outside [0, T)
  float* si = sr + span;
  float* mag = si + span;             // |ac| at q0 + i, i < TP + cp
  float* ccm = mag + DETECT_TP + cp;  // |cc| / 2K at t0 + i, i < TP
  const float* src = s + static_cast<size_t>(b) * 2 * T;
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    tr[i] = taps[i];
    ti[i] = taps[w + i];
  }
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int q = q0 + i;
    const bool in = q >= 0 && q < T;
    sr[i] = in ? src[q] : 0.f;
    si[i] = in ? src[T + q] : 0.f;
  }
  __syncthreads();

  // 1. per position: autocorrelation, energy and xcorr over the 2K window;
  //    |ac| is 0 before the chunk start (the reference's zero pre-pad)
  const float inv_w2 = 1.f / static_cast<float>(w * w);
  for (int i = threadIdx.x; i < DETECT_TP + cp; i += blockDim.x) {
    const int q = q0 + i;
    float m = 0.f;
    if (q >= 0 && q < d.n_ac) {
      const float* xr = sr + i;
      const float* xi = si + i;
      float pr = 0.f, pi = 0.f, e = 0.f, cr = 0.f, ci = 0.f;
      for (int j = 0; j < K; ++j) {
        const float ar = xr[j], ai = xi[j], br = xr[j + K], bi = xi[j + K];
        const float ur = tr[j], ui = ti[j], vr = tr[j + K], vi = ti[j + K];
        pr += ar * br + ai * bi;
        pi += ar * bi - ai * br;
        e += ar * ar + ai * ai + br * br + bi * bi;
        cr += ar * ur - ai * ui + br * vr - bi * vi;
        ci += ar * ui + ai * ur + br * vi + bi * vr;
      }
      e = fmaxf(e, 1e-30f);
      const float g = 2.f / e;
      if (LEAN) {
        m = sqrtf(pr * pr + pi * pi) * g;
      } else {
        const float acr = pr * g, aci = pi * g;
        m = sqrtf(acr * acr + aci * aci);
        if (i >= cp) {
          float* row = ac + static_cast<size_t>(b) * 2 * d.n_ac;
          row[q] = acr;
          row[d.n_ac + q] = aci;
          energy[static_cast<size_t>(b) * d.n_ac + q] = e;
        }
      }
      if (i >= cp) ccm[i - cp] = sqrtf((cr * cr + ci * ci) * inv_w2);
    }
    mag[i] = m;
  }
  __syncthreads();

  // 2. backward CP integration and the gated metric
  const float inv_cp1 = 1.f / static_cast<float>(cp + 1);
  for (int i = threadIdx.x; i < DETECT_TP; i += blockDim.x) {
    const int t = t0 + i;
    if (t >= n_out) continue;
    float acc = 0.f;
    for (int j = 0; j <= cp; ++j) acc = fmaf(mag[i + j], inv_cp1, acc);
    ic[static_cast<size_t>(b) * n_out + t] = acc;
    if (t < d.n_valid) gated[static_cast<size_t>(b) * d.n_valid + t] = ccm[i] * acc;
  }
}

template <bool LEAN>
int launch_detect(const DetectDims* d, const float* s, const float* taps,
                  float* gated, float* ac, float* energy, float* ic,
                  void* stream) {
  const int n_out = LEAN ? d->n_valid : d->n_ac;
  if (d->batch <= 0 || n_out <= 0) return 0;
  const size_t smem = sizeof(float) * detect_smem_floats(*d);
  cudaError_t err = cudaFuncSetAttribute(
      detect_kernel<LEAN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(d->batch) *
                           ((n_out + DETECT_TP - 1) / DETECT_TP);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  detect_kernel<LEAN><<<static_cast<unsigned>(blocks), DETECT_TP, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      *d, s, taps, gated, ac, energy, ic);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gfdm

extern "C" int gfdm_detect_front(const gfdm::DetectDims* d, const float* s,
                                 const float* taps, float* gated, float* ac,
                                 float* energy, float* ic, void* stream) {
  return gfdm::launch_detect<false>(d, s, taps, gated, ac, energy, ic, stream);
}

extern "C" int gfdm_detect_lean(const gfdm::DetectDims* d, const float* s,
                                const float* taps, float* gated, float* ac,
                                float* energy, float* ic, void* stream) {
  return gfdm::launch_detect<true>(d, s, taps, gated, ac, energy, ic, stream);
}

extern "C" size_t gfdm_detect_smem_bytes(const gfdm::DetectDims* d) {
  return sizeof(float) * gfdm::detect_smem_floats(*d);
}

extern "C" int gfdm_detect_dims_size() {
  return static_cast<int>(sizeof(gfdm::DetectDims));
}
