// The superseded GFDM receivers for Hopper (sm_90a). The production dense
// receiver (_rx_ic_circ_kernel, rx_receiver_fused) runs as staged
// tensor-core products in link.cu.
//
// rx_variant_kernel<TB, V> replaces the four superseded receiver variants as
// compile-time configurations of the stages of gfdm_common.cuh:
//   kChanIn   frames, channel (B, 2N) given: DFT, ZF, Bfd demod, and the
//             circulant QPSK IC at ic_iterations (0: _rx_core_kernel,
//             rx_core_fused; > 0: _rx_ic_kernel, rx_ic_fused, whose
//             block-diagonal (N, N) C pair is the same circulant);
//   kEstimate bursts: the channel estimated, then as kChanIn
//             (_rx_full_kernel, rx_full_fused, whose realified (2M, 2M) C_W
//             is the same circulant);
//   kHybrid   as kEstimate, with the L-tap fold and the per-subcarrier
//             M-point IDFTs in place of the Bfd product (_rx_hybrid_kernel,
//             rx_receiver_hybrid); the channel is also written out.
// None of the variants writes metrics. Their IC reads the (2, M) taps, the
// QPSK amplitude folded in, where the Pallas kernels multiply by the
// block-diagonal or realified operator (convert.py checks both against the
// taps).
//
// Bound: 2.21 M fp32 MACs a burst without IC (estimate, N-DFT,
// demodulator; 1.99 M with the channel given), plus 0.02 M per IC iteration, against
// 6 KB read and 9 KB written: FMA-bound, with about 10 MB of operator
// stacks streamed from L2 once per tile. The hybrid drops the 1.0 M-MAC Bfd
// product for N (L + M) complex MACs. Design: the tile's preamble window,
// payload block and the four N-wide planar stages (channel, DFT/ZF,
// demodulated, IC state) stay in shared memory (156 KB at TB = 8), so
// nothing but the outputs returns to HBM; the Pallas kernels' global rolls,
// mask blends and 0/1 selection matmuls become index arithmetic. The tile
// shrinks to 4, 2 or 1 bursts where a larger N needs it (rx_tile_bursts:
// K = 128, 256, 512).
#include "gfdm_common.cuh"

namespace gfdm {

enum RxVariant { kChanIn = 0, kEstimate = 1, kHybrid = 2 };

// A variant's two windows of TB bursts into the tile: preamble
// [cp, cp + 2K) into P and payload block [fs, fs + N) into F, per plane.
template <int TB>
__device__ inline void load_windows(const Dims& d, const float* src, int nb,
                                    const RxTile<TB>& t) {
  const int n = d.n, half = d.half, L = d.frame_len, w = 2 * n;
  const int fs = d.preamble_len + d.cp_len;
  for (int i = threadIdx.x; i < TB * 2 * half; i += blockDim.x) {
    const int b = i / (2 * half), j = i - b * 2 * half;
    const int p = j / half, s = j - p * half;
    t.P[i] = b < nb ? src[static_cast<size_t>(b) * 2 * L + p * L + d.cp_len + s] : 0.f;
  }
  for (int i = threadIdx.x; i < TB * w; i += blockDim.x) {
    const int b = i / w, j = i - b * w;
    const int p = j / n, s = j - p * n;
    t.F[i] = b < nb ? src[static_cast<size_t>(b) * 2 * L + p * L + fs + s] : 0.f;
  }
}

template <int TB>
__device__ inline void store_rows(const float* s, float* out, int nb, int w) {
  for (int i = threadIdx.x; i < nb * w; i += blockDim.x) out[i] = s[i];
}

// in: frames (B, 2N) for kChanIn, else bursts (B, 2 frame_len); chan_in
// (B, 2N) for kChanIn; chan_out (B, 2N) or null.
template <int TB, int V>
__global__ void __launch_bounds__(MAX_THREADS)
rx_variant_kernel(Dims d, Consts c, const float* __restrict__ in,
                  const float* __restrict__ chan_in, float* __restrict__ chan_out,
                  float* __restrict__ sym) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * TB;
  const int nb = min(TB, d.batch - b0);
  const int n = d.n, w = 2 * n;
  const RxTile<TB> t(d, smem);
  if constexpr (V == kChanIn) {
    load_tile<TB>(t.F, in + static_cast<size_t>(b0) * w, n, nb);
    load_tile<TB>(t.C, chan_in + static_cast<size_t>(b0) * w, n, nb);
    __syncthreads();
  } else {
    load_windows<TB>(d, in + static_cast<size_t>(b0) * 2 * d.frame_len, nb, t);
    __syncthreads();
    estimate_channel<TB, float>(d, c, t, nb,
                                chan_out == nullptr ? nullptr
                                                    : chan_out + static_cast<size_t>(b0) * w);
    __syncthreads();
  }
  dft_zf<TB, float>(d, c, t);
  if constexpr (V == kHybrid) {
    demod_hybrid<TB>(d, c, t);
  } else {
    demod_dense<TB, float>(d, c, t);
  }
  const float* s = cancel_interference<TB>(d, c, t);
  store_rows<TB>(s, sym + static_cast<size_t>(b0) * w, nb, w);
}

template <int TB, int V>
int launch_variant(const Dims* d, const Consts* c, const float* in,
                   const float* chan_in, float* chan_out, float* sym, void* stream) {
  const size_t smem = sizeof(float) * rx_smem_floats(*d, TB);
  cudaError_t err = cudaFuncSetAttribute(
      rx_variant_kernel<TB, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (d->batch + TB - 1) / TB;
  rx_variant_kernel<TB, V><<<blocks, block_threads(*d), smem,
                             static_cast<cudaStream_t>(stream)>>>(
      *d, *c, in, chan_in, chan_out, sym);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_variant_tile(const Dims* d, const Consts* c, const float* in,
                        const float* chan_in, float* chan_out, float* sym,
                        void* stream) {
  switch (rx_tile_bursts(*d)) {
    case 8: return launch_variant<8, V>(d, c, in, chan_in, chan_out, sym, stream);
    case 4: return launch_variant<4, V>(d, c, in, chan_in, chan_out, sym, stream);
    case 2: return launch_variant<2, V>(d, c, in, chan_in, chan_out, sym, stream);
    default: return launch_variant<1, V>(d, c, in, chan_in, chan_out, sym, stream);
  }
}

}  // namespace gfdm

// variant: 0 channel given, 1 channel estimated, 2 estimated + hybrid demod
// (gfdm::RxVariant); -1 for an unknown variant.
extern "C" int gfdm_rx_variant(const gfdm::Dims* d, const gfdm::Consts* c,
                               const float* in, const float* chan_in,
                               float* chan_out, float* sym, int variant,
                               void* stream) {
  if (d->batch <= 0) return 0;
  switch (variant) {
    case gfdm::kChanIn:
      return gfdm::launch_variant_tile<gfdm::kChanIn>(d, c, in, chan_in, chan_out, sym, stream);
    case gfdm::kEstimate:
      return gfdm::launch_variant_tile<gfdm::kEstimate>(d, c, in, chan_in, chan_out, sym, stream);
    case gfdm::kHybrid:
      return gfdm::launch_variant_tile<gfdm::kHybrid>(d, c, in, chan_in, chan_out, sym, stream);
    default:
      return -1;
  }
}
