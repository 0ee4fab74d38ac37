// Fused GFDM transmitter for Hopper (sm_90a).
//
// Replaces the Pallas kernel gfdm_tpu/kernels/fused.py::_tx_kernel
// (wrapper tx_frame_fused): payload (B, 2 n_data) -> Gauss 3-product with
// T_G (map + modulate folded in) -> CP/CS copies at the cyclic shift ->
// window -> planar preamble prepended -> bursts (B, 2 frame_len).
//
// Bound: at the canonical config the product is 0.81 M fp32 MACs a burst
// against 3.7 KB of payload read and 6 KB of burst written, so the kernel is
// bound by the FMA rate and by streaming the 3.2 MB T_G stack from L2 once
// per tile. Design: a tile of TB bursts stays in shared memory, each thread
// accumulates two core columns for all TB bursts in registers (so each T_G
// element read from L2 feeds 3 x TB FMAs) and scatters each core sample
// straight to its one to three burst positions; the CP/CS insertion is index
// arithmetic, no gather table.
#include "gfdm_common.cuh"

namespace gfdm {

constexpr int TX_TB = 8;  // bursts per CTA tile

__global__ void __launch_bounds__(MAX_THREADS)
tx_kernel(Dims d, Consts c, const float* __restrict__ data,
          float* __restrict__ out) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * TX_TB;
  const int nb = min(TX_TB, d.batch - b0);
  const float* src = data + static_cast<size_t>(b0) * 2 * d.n_data;
  float* dst = out + static_cast<size_t>(b0) * 2 * d.frame_len;
  load_tile<TX_TB>(smem, src, d.n_data, nb);
  __syncthreads();

  const int n = d.n, L = d.frame_len, p_len = d.preamble_len;
  const int lead = d.cp_len + d.shift;  // framed position of core sample 0
  const int head = n - lead;            // core samples >= head also form the CP
  const int tail = d.cs_len - d.shift;  // core samples < tail also form the CS
  tx_core<TX_TB>(d, c, smem, [&](int b, int col, float cr, float ci) {
    if (b >= nb) return;
    float* row = dst + static_cast<size_t>(b) * 2 * L + p_len;
    const float v[2] = {cr, ci};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float* r = row + p * L;
      int i = col + lead;
      r[i] = v[p] * c.win[i];
      if (col >= head) {
        i = col - head;
        r[i] = v[p] * c.win[i];
      }
      if (col < tail) {
        i = col + lead + n;
        r[i] = v[p] * c.win[i];
      }
    }
  });
  for (int i = threadIdx.x; i < nb * 2 * p_len; i += blockDim.x) {
    const int b = i / (2 * p_len), j = i - b * 2 * p_len;
    const int p = j / p_len, t = j - p * p_len;
    dst[static_cast<size_t>(b) * 2 * L + p * L + t] = c.pre[j];
  }
}

}  // namespace gfdm

extern "C" int gfdm_tx(const gfdm::Dims* d, const gfdm::Consts* c,
                       const float* data, float* out, void* stream) {
  if (d->batch <= 0) return 0;
  const size_t smem = sizeof(float) * gfdm::TX_TB * 2 * d->n_data;
  cudaError_t err = cudaFuncSetAttribute(
      gfdm::tx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (d->batch + gfdm::TX_TB - 1) / gfdm::TX_TB;
  gfdm::tx_kernel<<<blocks, gfdm::block_threads(*d), smem,
                    static_cast<cudaStream_t>(stream)>>>(*d, *c, data, out);
  return static_cast<int>(cudaGetLastError());
}
