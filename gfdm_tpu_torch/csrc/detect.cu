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
// Bound: the cross-correlation is 2K complex MACs (8K fp32 FMAs) a gated
// position; p, e and ic are window sums, a few operations a position when
// each term is added once; 8 bytes are read and 8 to 20 written a
// position. So the FMA pipes bound it, not HBM.
// Design: a CTA of DETECT_TP threads covers DETECT_TILE consecutive
// positions of one chunk, DETECT_R consecutive ones a thread, and stages
// the samples its windows reach as float2 in shared memory, zero outside
// [0, T), with one pad word after every R samples: the threads read
// R-strided addresses, and a stride of R + 1 words keeps them on distinct
// banks. H = ceil(cp / R) groups of R positions before the tile are the CP
// integration's halo (their |ac| only).
// - cc is a register-sliding FIR: a thread holds 2R samples in registers
//   and, a tap at a time (two taps a float4, read through L1 at an address
//   every lane shares), updates its R complex accumulators: 4R FMAs against
//   one 8-byte shared load a tap, and each position's sum runs over the
//   taps in order. The taps stay out of shared memory (staged there they
//   ran no faster at the service's shapes), which holds only samples,
//   block sums and |ac|, so K up to ~10,000 fits.
// - p, e and ic of R consecutive windows are the terms common to all R
//   windows, plus each window's head and tail. The common terms of p and e
//   are mostly whole blocks of R window entries, whose sums the CTA takes
//   once a block (not once a window) before any window. Every term is
//   added, none subtracted, so a power step of any size leaves no residue
//   in the next window's sum (a running sum that subtracts the leaving
//   term keeps the rounding error of a 60 dB louder past).
// - Every output trace is staged in shared memory over the dead sample
//   window and stored a row segment a warp (coalesced).
// tests/test_torch_detect_tiles.py replays this schedule in NumPy.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace gfdm {

// The tile, 2,048 positions: one CTA covers the service's 2,048-sample
// chunk; 64 registers a thread, four CTAs an SM.
constexpr int DETECT_TP = 256;                     // threads of a CTA
constexpr int DETECT_R = 8;                        // consecutive positions a thread (even)
constexpr int DETECT_MIN_CTAS = 4;                 // CTAs an SM the registers must allow
constexpr int DETECT_TILE = DETECT_TP * DETECT_R;  // positions of a CTA

// Sizes of one call. Field order mirrors kernels/cuda_lib.py::DetectDims.
struct DetectDims {
  int batch;        // B chunks, any value >= 0
  int length;       // T samples a chunk, any value > 2K
  int subcarriers;  // K: autocorrelation lag; the xcorr has 2K taps
  int cp_len;       // the CP integration window is cp_len + 1
  int n_ac;         // T - 2K positions with full windows
  int n_valid;      // min(n_ac, search_limit): positions of the gated metric
};

// Groups of R positions before a tile whose |ac| the CP integration reads.
__host__ __device__ inline int detect_halo(const DetectDims& d) {
  return (d.cp_len + DETECT_R - 1) / DETECT_R;
}

// Taps the FIR runs over: 2K rounded up to 2R (the taps past 2K are zero).
__host__ __device__ inline int detect_taps(const DetectDims& d) {
  return (2 * d.subcarriers + 2 * DETECT_R - 1) / (2 * DETECT_R) * (2 * DETECT_R);
}

// Samples a CTA stages: the halo's and the tile's positions, then as far
// as the last FIR block reads.
__host__ __device__ inline int detect_span(const DetectDims& d) {
  return (DETECT_TP + detect_halo(d)) * DETECT_R + detect_taps(d);
}

// Shared-memory word of window entry i: one pad word after every R.
__host__ __device__ inline int detect_pad(int i) { return i + i / DETECT_R; }

// Floats of the sample window (float2, padded).
__host__ __device__ inline size_t detect_window_floats(const DetectDims& d) {
  return 2 * static_cast<size_t>(detect_pad(detect_span(d)));
}

// Blocks of R window entries whose sums the windows' common terms take:
// 2K-wide energy sums and K-wide products.
__host__ __device__ inline int detect_energy_blocks(const DetectDims& d) {
  return DETECT_TP + detect_halo(d) + 2 * d.subcarriers / DETECT_R - 1;
}
__host__ __device__ inline int detect_product_blocks(const DetectDims& d) {
  return DETECT_TP + detect_halo(d) + d.subcarriers / DETECT_R - 1;
}

// Shared-memory floats of a CTA: the window, the block sums of products
// (float2) and energies, and |ac| (padded); the staged traces (five of the
// front kernel, two of the lean one) overlay them afterwards.
template <bool LEAN>
__host__ __device__ inline size_t detect_smem_floats(const DetectDims& d) {
  const size_t work = detect_window_floats(d) +
                      2 * static_cast<size_t>(detect_product_blocks(d)) +
                      detect_energy_blocks(d) +
                      static_cast<size_t>(DETECT_TP + detect_halo(d)) * (DETECT_R + 1);
  const size_t staged = static_cast<size_t>(LEAN ? 2 : 5) * DETECT_TP * (DETECT_R + 1);
  return work > staged ? work : staged;
}

__device__ __forceinline__ void detect_cmac(float2& acc, float2 s, float2 x) {
  acc.x = fmaf(s.x, x.x, acc.x);
  acc.x = fmaf(-s.y, x.y, acc.x);
  acc.y = fmaf(s.x, x.y, acc.y);
  acc.y = fmaf(s.y, x.x, acc.y);
}

// acc += conj(a) b
__device__ __forceinline__ void detect_cconj_mac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(-a.y, b.x, acc.y);
}

__device__ __forceinline__ float detect_norm_mac(float2 a, float acc) {
  return fmaf(a.y, a.y, fmaf(a.x, a.x, acc));
}

// R taps of the FIR: acc[r] += w[r + u] x_u for u < R, where w = (lo, hi)
// holds 2R consecutive samples.
__device__ __forceinline__ void detect_fir_block(float2 (&acc)[DETECT_R],
                                                 const float2 (&lo)[DETECT_R],
                                                 const float2 (&hi)[DETECT_R],
                                                 const float4* __restrict__ taps) {
  constexpr int R = DETECT_R;
#pragma unroll
  for (int u = 0; u < R; u += 2) {
    const float4 x = __ldg(taps + u / 2);
#pragma unroll
    for (int r = 0; r < R; ++r)
      detect_cmac(acc[r], r + u < R ? lo[r + u] : hi[r + u - R], make_float2(x.x, x.y));
#pragma unroll
    for (int r = 0; r < R; ++r)
      detect_cmac(acc[r], r + u + 1 < R ? lo[r + u + 1] : hi[r + u + 1 - R],
                  make_float2(x.z, x.w));
  }
}

// |cc| / 2K at the R positions whose first sample is w[0] (w: the padded
// window at a multiple of R).
__device__ __forceinline__ void detect_xcorr(const float2* w, const float4* __restrict__ taps,
                                             int n_taps, float inv_w2,
                                             float (&ccm)[DETECT_R]) {
  constexpr int R = DETECT_R;
  float2 acc[R], lo[R], hi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = make_float2(0.f, 0.f);
    lo[r] = w[r];
  }
  for (int j = 0; j < n_taps; j += 2 * R) {
    w += R + 1;
#pragma unroll
    for (int u = 0; u < R; ++u) hi[u] = w[u];
    detect_fir_block(acc, lo, hi, taps + j / 2);
    w += R + 1;
#pragma unroll
    for (int u = 0; u < R; ++u) lo[u] = w[u];
    detect_fir_block(acc, hi, lo, taps + j / 2 + R / 2);
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    ccm[r] = sqrtf((acc[r].x * acc[r].x + acc[r].y * acc[r].y) * inv_w2);
}

// The block sums of window block k (entries kR .. kR + R - 1), each over
// its R terms in order: be[k] of |s|^2, bp[k] of conj(s[n]) s[n + K].
__device__ __forceinline__ void detect_block_sums(const float2* win, int K, int n_energy,
                                                  int n_products, float* be, float2* bp) {
  constexpr int R = DETECT_R;
  for (int k = threadIdx.x; k < n_energy; k += DETECT_TP) {
    const float2* w = win + k * (R + 1);
    float e = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) e = detect_norm_mac(w[i], e);
    be[k] = e;
  }
  for (int k = threadIdx.x; k < n_products; k += DETECT_TP) {
    const float2* w = win + k * (R + 1);
    float2 p = make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < R; ++i) detect_cconj_mac(p, w[i], w[detect_pad(i + K)]);
    bp[k] = p;
  }
}

// p and the 2K energy of the R windows starting at w[0 .. R-1] (w: the
// padded window at a multiple of R; be, bp: the block sums from its block
// on). Window r holds the products n in [r, r + K) and the energies n in
// [r, r + 2K): the terms n in [R - 1, K) and [R - 1, 2K) are common to all
// R (the term R - 1, the block sums of the whole blocks after it, then the
// last K mod R or 2K mod R terms), the head [r, R - 1) and the tail (from
// K or 2K, r terms) are window r's own.
__device__ __forceinline__ void detect_pe(const float2* w, const float* be, const float2* bp,
                                          int K, float2 (&p)[DETECT_R],
                                          float (&e)[DETECT_R]) {
  constexpr int R = DETECT_R;
  if (K >= R - 1) {
    float2 pc = make_float2(0.f, 0.f);
    if (K >= R) {
      detect_cconj_mac(pc, w[R - 1], w[detect_pad(R - 1 + K)]);
      for (int k = 1; k < K / R; ++k) {
        pc.x += bp[k].x;
        pc.y += bp[k].y;
      }
      for (int n = K / R * R; n < K; ++n)
        detect_cconj_mac(pc, w[detect_pad(n)], w[detect_pad(n + K)]);
    }
    float ec = detect_norm_mac(w[R - 1], 0.f);
    for (int k = 1; k < 2 * K / R; ++k) ec += be[k];
    for (int n = 2 * K / R * R; n < 2 * K; ++n) ec = detect_norm_mac(w[detect_pad(n)], ec);
    float2 hp = make_float2(0.f, 0.f);
    float he = 0.f;
    p[R - 1] = pc;
    e[R - 1] = ec;
#pragma unroll
    for (int r = R - 2; r >= 0; --r) {
      const float2 a = w[r];
      detect_cconj_mac(hp, a, w[detect_pad(K + r)]);
      he = detect_norm_mac(a, he);
      p[r] = make_float2(pc.x + hp.x, pc.y + hp.y);
      e[r] = ec + he;
    }
    float2 tp = make_float2(0.f, 0.f);
    float te = 0.f;
#pragma unroll
    for (int r = 1; r < R; ++r) {
      const float2 b = w[detect_pad(2 * K + r - 1)];
      detect_cconj_mac(tp, w[detect_pad(K + r - 1)], b);
      te = detect_norm_mac(b, te);
      p[r].x += tp.x;
      p[r].y += tp.y;
      e[r] += te;
    }
  } else {  // K < R - 1: no term is common to all R windows
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float2 pr = make_float2(0.f, 0.f);
      float er = 0.f;
      for (int j = 0; j < K; ++j) {
        const float2 a = w[detect_pad(r + j)], b = w[detect_pad(r + j + K)];
        detect_cconj_mac(pr, a, b);
        er = detect_norm_mac(b, detect_norm_mac(a, er));
      }
      p[r] = pr;
      e[r] = er;
    }
  }
}

// |ac| of the R positions q .. q + R - 1 at window entry L into mag (0
// outside [0, n_ac)); the ac planes and e into acr, aci, en.
template <bool LEAN>
__device__ __forceinline__ void detect_mag(const float2* win, const float* be,
                                           const float2* bp, int L, int q,
                                           const DetectDims& d, float* mag,
                                           float (&acr)[DETECT_R], float (&aci)[DETECT_R],
                                           float (&en)[DETECT_R]) {
  float2 p[DETECT_R];
  float e[DETECT_R];
  const int blk = L / DETECT_R;
  detect_pe(win + detect_pad(L), be + blk, bp + blk, d.subcarriers, p, e);
#pragma unroll
  for (int r = 0; r < DETECT_R; ++r) {
    const float ev = fmaxf(e[r], 1e-30f);
    const float g = 2.f / ev;
    float m;
    if (LEAN) {
      m = sqrtf(p[r].x * p[r].x + p[r].y * p[r].y) * g;
    } else {
      acr[r] = p[r].x * g;
      aci[r] = p[r].y * g;
      en[r] = ev;
      m = sqrtf(acr[r] * acr[r] + aci[r] * aci[r]);
    }
    const int t = q + r;
    mag[detect_pad(L + r)] = t >= 0 && t < d.n_ac ? m : 0.f;
  }
}

// The backward CP integration at R positions from window entry L:
// ic[r] = sum_{j=0..cp} mag[L + r - j] / (cp + 1), as common terms, heads
// and tails when cp + 1 >= R - 1.
__device__ __forceinline__ void detect_ic(const float* mag, int L, int cp,
                                          float (&ic)[DETECT_R]) {
  constexpr int R = DETECT_R;
  const int u0 = L - cp, W = cp + 1;
  if (W >= R - 1) {
    float c = 0.f;
    for (int n = R - 1; n < W; ++n) c += mag[detect_pad(u0 + n)];
    float h = 0.f;
    ic[R - 1] = c;
#pragma unroll
    for (int r = R - 2; r >= 0; --r) {
      h += mag[detect_pad(u0 + r)];
      ic[r] = c + h;
    }
    float t = 0.f;
#pragma unroll
    for (int r = 1; r < R; ++r) {
      t += mag[detect_pad(u0 + W + r - 1)];
      ic[r] += t;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc = 0.f;
      for (int j = 0; j <= cp; ++j) acc += mag[detect_pad(L + r - j)];
      ic[r] = acc;
    }
  }
  const float cp1 = static_cast<float>(cp + 1);
#pragma unroll
  for (int r = 0; r < R; ++r) ic[r] /= cp1;
}

template <bool LEAN>
__global__ void __launch_bounds__(DETECT_TP, DETECT_MIN_CTAS)
detect_kernel(DetectDims d, const float* __restrict__ s, const float4* __restrict__ taps,
              float* __restrict__ gated, float* __restrict__ ac,
              float* __restrict__ energy, float* __restrict__ ic) {
  extern __shared__ float4 detect_sm[];
  constexpr int R = DETECT_R, TP = DETECT_TP, S = DETECT_TP * (DETECT_R + 1);
  const int T = d.length;
  const int n_out = LEAN ? d.n_valid : d.n_ac;  // positions of ic written
  const int tiles = (n_out + DETECT_TILE - 1) / DETECT_TILE;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * DETECT_TILE;
  const int H = detect_halo(d);
  const int q0 = t0 - H * R;  // position of window entry 0
  const int n_energy = detect_energy_blocks(d), n_products = detect_product_blocks(d);
  float2* win = reinterpret_cast<float2*>(detect_sm);  // samples from q0
  float* stage = reinterpret_cast<float*>(detect_sm);  // at last: the traces over all
  float2* bp = reinterpret_cast<float2*>(stage + detect_window_floats(d));
  float* be = reinterpret_cast<float*>(bp + n_products);
  float* mag = be + n_energy;  // |ac| at q0 + i
  // a tile past n_out - R stages and sums only what its busy groups read
  const int idle = TP - min(TP, (n_out - t0 + R - 1) / R);
  const int span = detect_span(d) - idle * R;
  const float* src = s + static_cast<size_t>(b) * 2 * T;
  for (int i = threadIdx.x; i < span; i += TP) {
    const int q = q0 + i;
    const bool in = q >= 0 && q < T;
    win[detect_pad(i)] = make_float2(in ? src[q] : 0.f, in ? src[T + q] : 0.f);
  }
  __syncthreads();
  if (d.subcarriers >= R - 1) {
    detect_block_sums(win, d.subcarriers, n_energy - idle, n_products - idle, be, bp);
    __syncthreads();
  }

  // 1. the first H threads: the halo's |ac|; every thread at its R
  //    positions: |cc| / 2K where gated is written, then p, e and |ac|
  const int g = threadIdx.x;
  if (g < H) {
    float hr[R], hi[R], he[R];
    detect_mag<LEAN>(win, be, bp, g * R, q0 + g * R, d, mag, hr, hi, he);
  }
  const int L = (H + g) * R;  // window entry of the thread's first position
  const int base = t0 + g * R;
  float ccm[R], acr[R], aci[R], en[R];
#pragma unroll
  for (int r = 0; r < R; ++r) ccm[r] = acr[r] = aci[r] = en[r] = 0.f;
  if (base < d.n_valid) {
    const float w = 2.f * static_cast<float>(d.subcarriers);
    detect_xcorr(win + detect_pad(L), taps, detect_taps(d), 1.f / (w * w), ccm);
  }
  if (base < n_out) detect_mag<LEAN>(win, be, bp, L, base, d, mag, acr, aci, en);
  __syncthreads();

  // 2. the CP integration and the gated metric; past the next barrier no
  //    thread reads the window, the block sums or |ac|, and every trace is
  //    staged over them
  float icv[R];
  if (base < n_out) detect_ic(mag, L, d.cp_len, icv);
  __syncthreads();
  if (base < n_out) {
    float* row = stage + g * (R + 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      row[r] = ccm[r] * icv[r];
      row[S + r] = icv[r];
      if (!LEAN) {
        row[2 * S + r] = acr[r];
        row[3 * S + r] = aci[r];
        row[4 * S + r] = en[r];
      }
    }
  }
  __syncthreads();

  // 3. coalesced stores: position t0 + i from stage entry i
  const size_t b_valid = static_cast<size_t>(b) * d.n_valid;
  const size_t b_out = static_cast<size_t>(b) * n_out;
  for (int k = 0; k < R; ++k) {
    const int i = threadIdx.x + k * TP, t = t0 + i;
    if (t >= n_out) break;
    const int si = detect_pad(i);
    if (t < d.n_valid) gated[b_valid + t] = stage[si];
    ic[b_out + t] = stage[S + si];
    if (!LEAN) {
      float* row = ac + static_cast<size_t>(b) * 2 * d.n_ac;
      row[t] = stage[2 * S + si];
      row[d.n_ac + t] = stage[3 * S + si];
      energy[b_out + t] = stage[4 * S + si];
    }
  }
}

template <bool LEAN>
int launch_detect(const DetectDims* d, const float* s, const float* taps, float* gated,
                  float* ac, float* energy, float* ic, void* stream) {
  const int n_out = LEAN ? d->n_valid : d->n_ac;
  if (d->batch <= 0 || n_out <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(taps) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = sizeof(float) * detect_smem_floats<LEAN>(*d);
  if (smem > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();  // report this launch's error only (earlier calls reported theirs)
  cudaError_t err = cudaFuncSetAttribute(
      detect_kernel<LEAN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // a refused launch leaves no error behind
    return static_cast<int>(err);
  }
  const long long blocks = static_cast<long long>(d->batch) *
                           ((n_out + DETECT_TILE - 1) / DETECT_TILE);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  detect_kernel<LEAN><<<static_cast<unsigned>(blocks), DETECT_TP, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      *d, s, reinterpret_cast<const float4*>(taps), gated, ac, energy, ic);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gfdm

// taps: x_j as interleaved [re, im] float32 pairs, 16-byte aligned, zero
// for 2K <= j < detect_taps (the wrapper pads them to a multiple of 64).
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

// The front kernel's shared memory a CTA; the lean kernel's is the same
// wherever the window, block sums and |ac| outweigh the five staged traces
// (K > ~700 at the canonical cp_len), and so wherever a launch can be
// refused.
extern "C" size_t gfdm_detect_smem_bytes(const gfdm::DetectDims* d) {
  return sizeof(float) * gfdm::detect_smem_floats<false>(*d);
}

extern "C" int gfdm_detect_dims_size() {
  return static_cast<int>(sizeof(gfdm::DetectDims));
}

// The detection tile: out = (threads of a CTA, consecutive positions a thread).
extern "C" int gfdm_detect_tile(int* out) {
  out[0] = gfdm::DETECT_TP;
  out[1] = gfdm::DETECT_R;
  return 0;
}
