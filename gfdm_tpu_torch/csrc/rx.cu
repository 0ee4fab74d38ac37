// Fused GFDM receiver for Hopper (sm_90a).
//
// Replaces the Pallas kernel gfdm_tpu/kernels/fused.py::_rx_ic_circ_kernel
// (wrappers rx_receiver_fused, receive_bursts_fused) for the ZF equalizer,
// QPSK decisions and both IC modes: bursts (B, 2 frame_len) -> channel
// estimate (B, 2N), symbols (B, 2N) and metrics (B, met_w) =
// [snr_lin | cnrs | 0-pad].
//
// Bound: 2.26 M fp32 MACs a burst without IC (estimate, 2K-DFT, N-DFT,
// demodulator), plus 1.0 M per IC iteration in matmul mode (0.02 M in conv
// mode), against 6 KB read and 9 KB written: FMA-bound, with about 10 MB of
// operator stacks streamed from L2 once per tile. Design: the tile's
// preamble window, payload block and the four N-wide planar stages
// (channel, DFT/ZF, demodulated, IC state) stay in shared memory (156 KB at
// TB = 8), so nothing but the outputs returns to HBM; the Pallas kernel's
// global rolls, mask blends and 0/1 selection matmuls become index
// arithmetic. The tile shrinks to 4, 2 or 1 bursts where a larger N needs
// it (rx_tile_bursts: K = 128, 256, 512).
#include "gfdm_common.cuh"

namespace gfdm {

template <int TB>
__global__ void __launch_bounds__(MAX_THREADS)
rx_kernel(Dims d, Consts c, const float* __restrict__ bursts,
          float* __restrict__ chan, float* __restrict__ sym,
          float* __restrict__ met) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * TB;
  const int nb = min(TB, d.batch - b0);
  const int n = d.n, half = d.half, L = d.frame_len, w = 2 * n;
  const int fs = d.preamble_len + d.cp_len;
  const float* src = bursts + static_cast<size_t>(b0) * 2 * L;
  float* P = smem;
  float* F = P + TB * 2 * half;
  // the receiver's two windows of the burst: preamble [cp, cp + 2K) and
  // payload block [fs, fs + N), per plane
  for (int i = threadIdx.x; i < TB * 2 * half; i += blockDim.x) {
    const int b = i / (2 * half), j = i - b * 2 * half;
    const int p = j / half, t = j - p * half;
    P[i] = b < nb ? src[static_cast<size_t>(b) * 2 * L + p * L + d.cp_len + t] : 0.f;
  }
  for (int i = threadIdx.x; i < TB * w; i += blockDim.x) {
    const int b = i / w, j = i - b * w;
    const int p = j / n, t = j - p * n;
    F[i] = b < nb ? src[static_cast<size_t>(b) * 2 * L + p * L + fs + t] : 0.f;
  }
  __syncthreads();
  const float* s = rx_chain<TB>(d, c, smem, nb,
                            chan + static_cast<size_t>(b0) * w,
                            met + static_cast<size_t>(b0) * d.met_w);
  float* out = sym + static_cast<size_t>(b0) * w;
  for (int i = threadIdx.x; i < nb * w; i += blockDim.x) out[i] = s[i];
}

template <int TB>
int launch_rx(const Dims* d, const Consts* c, const float* bursts, float* chan,
              float* sym, float* met, void* stream) {
  const size_t smem = sizeof(float) * rx_smem_floats(*d, TB);
  cudaError_t err = cudaFuncSetAttribute(
      rx_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (d->batch + TB - 1) / TB;
  rx_kernel<TB><<<blocks, block_threads(*d), smem,
                  static_cast<cudaStream_t>(stream)>>>(*d, *c, bursts, chan,
                                                       sym, met);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gfdm

// A config whose one-burst tile exceeds shared memory runs the TB = 1
// launch, which the runtime refuses.
extern "C" int gfdm_rx(const gfdm::Dims* d, const gfdm::Consts* c,
                       const float* bursts, float* chan, float* sym,
                       float* met, void* stream) {
  if (d->batch <= 0) return 0;
  switch (gfdm::rx_tile_bursts(*d)) {
    case 8: return gfdm::launch_rx<8>(d, c, bursts, chan, sym, met, stream);
    case 4: return gfdm::launch_rx<4>(d, c, bursts, chan, sym, met, stream);
    case 2: return gfdm::launch_rx<2>(d, c, bursts, chan, sym, met, stream);
    default: return gfdm::launch_rx<1>(d, c, bursts, chan, sym, met, stream);
  }
}
