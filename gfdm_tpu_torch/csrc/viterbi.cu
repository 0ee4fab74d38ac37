// Soft-decision Viterbi decoder for Hopper (sm_90a): the radix-2^k
// add-compare-select (ACS) recursion of the rate-1/2, K = 7 code and its
// traceback in one launch for a batch of codewords.
//
// Replaces no Pallas kernel: the JAX package decodes with lax.scan, and the
// port's torch-op decoder (coding._pattern_sums / _forward / _traceback) is
// kept as the plain version. It launched about eight kernels a collapsed
// trellis step and wrote the (S, B, 2^(2k)) pattern sums and (S, B, 64)
// decisions to device memory; this kernel keeps both in shared memory.
//
// Arithmetic (bit-identical to the plain version on any float32 input):
// - pattern sums: column q of a step's 2^(2k) sums is the left fold
//   +-l0 +- l1 ... +- l(2k-1), term i negated where bit 2k-1-i of q is set,
//   each partial sum rounded to float32 (__fadd_rn / __fsub_rn);
// - a next state ns has 2^k predecessors p = (ns >> k) | (j << (6 - k));
//   candidate j is pm[p] + pat[q(ns, j)] and the survivor is the first j
//   of the maxima, or the first NaN, as torch.max(dim) on the CPU picks;
// - q(ns, j) = q_j[j] ^ q_ns[ns]: the pattern index is the code's 2k output
//   bits, linear over GF(2) in the input sequence (j bits, then ns's), so
//   the host hands two small tables instead of 64 x 2^k entries;
// - the traceback starts at state 0 (zero-terminated) or, per codeword, at
//   the first argmax of the final metrics (the windowed decoder's interior
//   windows), and steps back with prev = (s >> k) | (j << (6 - k)).
//
// Bound: fp32 adds and compares. A step of a codeword forms 2^(2k+1) - 2
// pattern-sum adds and 64 x 2^k candidate adds and compares: at k = 4,
// B = 4,096, T = 1,404 (351 steps) ~3.7 G operations, ~0.11 ms at the
// H100's 33.5 T non-FMA fp32 operations a second; the LLRs are 46 MB in
// (~14 us at 3.35 TB/s) and the bits 5.7 MB out.
// Design: the S steps of a codeword are a dependent chain, so the kernel
// gives each codeword one warp and keeps many warps on each SM to hide the
// chain's latency. Lane L owns next states 2L and 2L + 1, which share
// their 2^k predecessors, so a lane reads 2^k metrics for 2^(k+1)
// candidates. The 64 metrics and the step's pattern sums sit in
// double-buffered shared memory, so one __syncwarp a step orders them.
// Each lane reads the step's 2k LLRs with 8- or 16-byte loads one step
// ahead (every lane the same address: one request a warp). A lane packs
// its two k-bit decisions of PER = 16 / k consecutive steps into one
// 32-bit word, ~8 T bytes a codeword for every k, which lane 0 walks back
// after the last step; the warp then writes the T bits as bytes.
// A block holds VIT_WARPS = 8 codewords: at B = 4,096 radix 16, 1 / 2 / 4 /
// 8 took 0.187 / 0.190 / 0.187 / 0.187 ms at T = 468 and 0.595 / 0.594 /
// 0.580 / 0.559 ms at T = 1,404 (H100, PERF.md row 15). The decision words
// and traced states live in shared memory where a block's fit (T up to
// ~3,200 for every k); past that the caller hands a global scratch of
// gfdm_viterbi_scratch_bytes a codeword and the same kernel keeps them
// there (long codewords, e.g. the factored receiver's K = 1,024 bursts).

#include <cuda_runtime.h>
#include <stdint.h>

namespace gfdm {

// The pattern index of a transition: q(ns, j) = q_j[j] ^ q_ns[ns].
struct ViterbiTables {
  int q_j[16];
  int q_ns[64];
};

constexpr int VIT_STATES = 64;
constexpr int VIT_WARPS = 8;  // codewords a block
constexpr float VIT_NEG = -1e30f;  // an unreachable state's metric (coding._NEG)

template <int K>
struct VitShape {
  static constexpr int NJ = 1 << K;                      // candidates a next state
  static constexpr int NQ = 1 << (2 * K);                // pattern sums a step
  static constexpr int NPL = NQ >= 32 ? NQ / 32 : 1;     // pattern sums a lane
  static constexpr int LB = NQ >= 32 ? 5 : 2 * K;        // terms set by the lane's bits
  static constexpr int TB = 2 * K - LB;                  // terms folded per lane
  static constexpr int PER = 16 / K;                     // steps a decision word holds
};

__host__ __device__ inline size_t vit_align16(size_t b) { return (b + 15) & ~size_t(15); }

// Bytes of one codeword's decision words and traced states (a multiple of 16).
template <int K>
__host__ __device__ inline size_t vit_dec_bytes(int S) {
  const size_t words = static_cast<size_t>((S + VitShape<K>::PER - 1) / VitShape<K>::PER) * 32;
  return sizeof(uint32_t) * words + vit_align16(static_cast<size_t>(S));
}

// Shared bytes of one warp: pattern sums and metrics (both double-buffered),
// then, unless they sit in the global scratch, the decisions and states.
template <int K>
__host__ __device__ inline size_t vit_warp_bytes(int S, bool global_dec) {
  return sizeof(float) * (2 * VitShape<K>::NQ + 2 * VIT_STATES) +
         (global_dec ? 0 : vit_dec_bytes<K>(S));
}

template <int K>
__device__ __forceinline__ void vit_load(const float* p, float (&l)[2 * K]) {
  if constexpr (K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
      l[4 * i] = v.x, l[4 * i + 1] = v.y, l[4 * i + 2] = v.z, l[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(p) + i);
      l[2 * i] = v.x, l[2 * i + 1] = v.y;
    }
  }
}

// One warp a codeword. llr: (B, T, 2) float32, 16-byte aligned; pm0: (B, 64)
// initial metrics or null (state 0 pinned); from_argmax: (B,) flags or null
// (every traceback from state 0); scratch: vit_dec_bytes a codeword where
// GDEC (the decisions kept in global memory), else unused; bits: (B, T) uint8.
template <int K, bool GDEC>
__global__ void __launch_bounds__(32 * VIT_WARPS) viterbi_kernel(
    const ViterbiTables tab, int batch, int T, const float* __restrict__ llr,
    const float* __restrict__ pm0, const uint8_t* __restrict__ from_argmax,
    unsigned char* __restrict__ scratch, uint8_t* __restrict__ bits) {
  using V = VitShape<K>;
  extern __shared__ __align__(16) unsigned char vit_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * VIT_WARPS + warp;
  if (b >= batch) return;  // whole warps only: no __syncwarp waits on a gone lane
  const int S = T / K;

  unsigned char* base = vit_smem + static_cast<size_t>(warp) * vit_warp_bytes<K>(S, GDEC);
  float* pat = reinterpret_cast<float*>(base);              // [2][NQ]
  float* pm = pat + 2 * V::NQ;                              // [2][64]
  unsigned char* dbase = GDEC ? scratch + static_cast<size_t>(b) * vit_dec_bytes<K>(S)
                              : reinterpret_cast<unsigned char*>(pm + 2 * VIT_STATES);
  uint32_t* dec = reinterpret_cast<uint32_t*>(dbase);       // [words][32]
  const int n_words = (S + V::PER - 1) / V::PER;
  uint8_t* states = reinterpret_cast<uint8_t*>(dec + n_words * 32);  // [S]

  // this lane's next states 2L, 2L + 1: their predecessors' shared bits
  // and the states' part of the pattern index
  const int hi = (2 * lane) >> K;
  const int qs0 = tab.q_ns[2 * lane], qs1 = tab.q_ns[2 * lane + 1];

  if (pm0 != nullptr) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(pm0 + static_cast<size_t>(b) * 64) +
                           lane);
    reinterpret_cast<float2*>(pm)[lane] = v;
  } else {
    reinterpret_cast<float2*>(pm)[lane] = make_float2(lane == 0 ? 0.0f : VIT_NEG, VIT_NEG);
  }

  const float* src = llr + static_cast<size_t>(b) * 2 * T;
  float l[2 * K];
  vit_load<K>(src, l);
  for (int w = 0; w < n_words; ++w) {
    uint32_t word = 0;
#pragma unroll
    for (int u = 0; u < V::PER; ++u) {
      const int s = w * V::PER + u;
      if (s >= S) break;
      float nl[2 * K];
      if (s + 1 < S) vit_load<K>(src + 2 * K * (s + 1), nl);
      float* pc = pat + (s & 1) * V::NQ;
      const float* mc = pm + (s & 1) * VIT_STATES;
      float* mn = pm + ((s & 1) ^ 1) * VIT_STATES;

      // the step's pattern sums: the lane's bits fix the signs of the first
      // LB terms, then a tree over the last TB terms gives NPL sums
      if (lane < V::NQ / V::NPL) {
        float v[V::NPL];
        v[0] = ((lane >> (V::LB - 1)) & 1) ? -l[0] : l[0];
#pragma unroll
        for (int i = 1; i < V::LB; ++i)
          v[0] = ((lane >> (V::LB - 1 - i)) & 1) ? __fsub_rn(v[0], l[i]) : __fadd_rn(v[0], l[i]);
#pragma unroll
        for (int i = 0; i < V::TB; ++i) {
          const int n = 1 << i;  // sums so far; index m -> 2m (+) and 2m + 1 (-)
#pragma unroll
          for (int m = n - 1; m >= 0; --m) {
            const float x = v[m];
            v[2 * m] = __fadd_rn(x, l[V::LB + i]);
            v[2 * m + 1] = __fsub_rn(x, l[V::LB + i]);
          }
        }
        if constexpr (V::NPL % 4 == 0) {
#pragma unroll
          for (int m = 0; m < V::NPL; m += 4)
            *reinterpret_cast<float4*>(pc + lane * V::NPL + m) =
                make_float4(v[m], v[m + 1], v[m + 2], v[m + 3]);
        } else if constexpr (V::NPL == 2) {
          *reinterpret_cast<float2*>(pc + 2 * lane) = make_float2(v[0], v[1]);
        } else {
          pc[lane] = v[0];
        }
      }
      __syncwarp();

      // add-compare-select for states 2L and 2L + 1
      float a[V::NJ];
#pragma unroll
      for (int j = 0; j < V::NJ; ++j) a[j] = mc[(j << (6 - K)) | hi];
      float best0 = __fadd_rn(a[0], pc[tab.q_j[0] ^ qs0]);
      float best1 = __fadd_rn(a[0], pc[tab.q_j[0] ^ qs1]);
      int j0 = 0, j1 = 0;
#pragma unroll
      for (int j = 1; j < V::NJ; ++j) {
        const float c0 = __fadd_rn(a[j], pc[tab.q_j[j] ^ qs0]);
        const float c1 = __fadd_rn(a[j], pc[tab.q_j[j] ^ qs1]);
        // torch.max: the first maximum, or the first NaN (then no more)
        if (!(c0 <= best0) && best0 == best0) best0 = c0, j0 = j;
        if (!(c1 <= best1) && best1 == best1) best1 = c1, j1 = j;
      }
      reinterpret_cast<float2*>(mn)[lane] = make_float2(best0, best1);
      word |= static_cast<uint32_t>(j0 | (j1 << K)) << (u * 2 * K);
#pragma unroll
      for (int i = 0; i < 2 * K; ++i) l[i] = nl[i];
    }
    dec[w * 32 + lane] = word;
  }
  __syncwarp();

  if (lane == 0) {
    int state = 0;
    if (from_argmax != nullptr && from_argmax[b]) {  // torch.argmax: first NaN, else first max
      const float* f = pm + (S & 1) * VIT_STATES;
      float best = f[0];
      for (int i = 1; i < VIT_STATES && best == best; ++i) {
        const float x = f[i];
        if (!(x <= best)) best = x, state = i;
      }
    }
    for (int s = S - 1; s >= 0; --s) {
      states[s] = static_cast<uint8_t>(state);
      if (s == 0) break;
      const uint32_t word = dec[(s / V::PER) * 32 + (state >> 1)];
      const int j = (word >> ((s % V::PER) * 2 * K + (state & 1) * K)) & (V::NJ - 1);
      state = (state >> K) | (j << (6 - K));
    }
  }
  __syncwarp();
  uint8_t* out = bits + static_cast<size_t>(b) * T;
  for (int t = lane; t < S * K; t += 32) {
    const int s = t / K;
    out[t] = static_cast<uint8_t>((states[s] >> (K - 1 - (t - s * K))) & 1);
  }
}

template <int K>
int launch_viterbi(const ViterbiTables* tab, int batch, int T, const float* llr,
                   const float* pm0, const uint8_t* from_argmax, unsigned char* scratch,
                   uint8_t* bits, cudaStream_t stream) {
  if (batch <= 0) return 0;
  if (T < K || T % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(llr) % 16 != 0 || reinterpret_cast<uintptr_t>(pm0) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  (void)cudaGetLastError();  // report this launch's error only (earlier calls reported theirs)
  const bool global_dec = scratch != nullptr;
  const size_t smem = VIT_WARPS * vit_warp_bytes<K>(T / K, global_dec);
  auto kernel = global_dec ? &viterbi_kernel<K, true> : &viterbi_kernel<K, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // a refused launch leaves no error behind
    return static_cast<int>(err);
  }
  const int blocks = (batch + VIT_WARPS - 1) / VIT_WARPS;
  kernel<<<blocks, 32 * VIT_WARPS, smem, stream>>>(*tab, batch, T, llr, pm0, from_argmax,
                                                   scratch, bits);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int viterbi_scratch(int T, size_t* bytes) {
  if (T < K || T % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();  // as the launcher: an earlier call's error is not this one's
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();
    return static_cast<int>(err);
  }
  const bool fits = VIT_WARPS * vit_warp_bytes<K>(T / K, false) <= static_cast<size_t>(optin);
  *bytes = fits ? 0 : vit_dec_bytes<K>(T / K);
  return 0;
}

}  // namespace gfdm

// Decode ``batch`` codewords of T trellis steps, k steps a collapsed step
// (k in 1..4, T a multiple of k). ``scratch``: null, or
// gfdm_viterbi_scratch_bytes a codeword of 16-byte aligned device memory
// where the decisions do not fit in shared memory.
extern "C" int gfdm_viterbi(const gfdm::ViterbiTables* tab, int batch, int T, int k,
                            const float* llr, const float* pm0, const uint8_t* from_argmax,
                            unsigned char* scratch, uint8_t* bits, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return gfdm::launch_viterbi<1>(tab, batch, T, llr, pm0, from_argmax, scratch, bits, s);
    case 2: return gfdm::launch_viterbi<2>(tab, batch, T, llr, pm0, from_argmax, scratch, bits, s);
    case 3: return gfdm::launch_viterbi<3>(tab, batch, T, llr, pm0, from_argmax, scratch, bits, s);
    case 4: return gfdm::launch_viterbi<4>(tab, batch, T, llr, pm0, from_argmax, scratch, bits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Global scratch bytes a codeword of T steps at radix 2^k needs on the
// current device: 0 where a block's decisions fit in shared memory.
// ``stream`` is unused (the launch() calling convention).
extern "C" int gfdm_viterbi_scratch_bytes(int T, int k, size_t* bytes, void* stream) {
  (void)stream;
  switch (k) {
    case 1: return gfdm::viterbi_scratch<1>(T, bytes);
    case 2: return gfdm::viterbi_scratch<2>(T, bytes);
    case 3: return gfdm::viterbi_scratch<3>(T, bytes);
    case 4: return gfdm::viterbi_scratch<4>(T, bytes);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int gfdm_viterbi_tables_size() {
  return static_cast<int>(sizeof(gfdm::ViterbiTables));
}
