// Fused GFDM transmitter for Hopper (sm_90a), one port or every CDD port.
//
// Replaces the Pallas kernels gfdm_tpu/kernels/fused.py::_tx_kernel
// (wrapper tx_frame_fused: one cyclic shift) and ::_tx_cdd_kernel (wrapper
// tx_cdd_fused: every cyclic-delay-diversity port): payload (B, 2 n_data)
// -> Gauss 3-product with T_G (map + modulate folded in) -> for each port p,
// CP/CS copies at its cyclic shift -> window -> its planar preamble ->
// bursts (B, n_ports, 2 frame_len).
//
// Bound: at the canonical config the product is 0.81 M fp32 MACs a burst
// against 3.7 KB of payload read and 6 KB of burst written a port, so the
// kernel is bound by the FMA rate (two ports: 1.03 GB of traffic at
// B = 65,536 still take less time than the 106 GFLOP), and by streaming the
// 3.2 MB T_G stack from L2 once per tile. Design: a tile of TB bursts stays
// in shared memory, each thread accumulates two core columns for all TB
// bursts in registers (so each T_G element read from L2 feeds 3 x TB FMAs),
// and the core is computed ONCE per tile whatever the port count: the
// epilogue loops over the ports and scatters each core sample straight to
// its one to three burst positions in every port (CP/CS insertion by index
// arithmetic, no gather table); the preambles are indexed per port.
#include "gfdm_common.cuh"

namespace gfdm {

constexpr int TX_TB = 8;  // bursts per CTA tile

__global__ void __launch_bounds__(MAX_THREADS)
tx_kernel(Dims d, Consts c, const float* __restrict__ data,
          float* __restrict__ out) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * TX_TB;
  const int nb = min(TX_TB, d.batch - b0);
  const int n = d.n, L = d.frame_len, p_len = d.preamble_len, ports = d.n_ports;
  const size_t row = static_cast<size_t>(ports) * 2 * L;  // one burst, all ports
  const float* src = data + static_cast<size_t>(b0) * 2 * d.n_data;
  float* dst = out + static_cast<size_t>(b0) * row;
  load_tile<TX_TB>(smem, src, d.n_data, nb);
  __syncthreads();

  tx_core<TX_TB, float>(d, c, smem, [&](int b, int col, float cr, float ci) {
    if (b >= nb) return;
    const float v[2] = {cr, ci};
    for (int port = 0; port < ports; ++port) {
      const int shift = __ldg(c.shifts + port);
      const int lead = d.cp_len + shift;  // framed position of core sample 0
      const int head = n - lead;          // core samples >= head also form the CP
      const int tail = d.cs_len - shift;  // core samples < tail also form the CS
      float* burst = dst + static_cast<size_t>(b) * row + static_cast<size_t>(port) * 2 * L + p_len;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float* r = burst + p * L;
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
    }
  });
  // preambles: port p's planar (2, p_len) row heads its two planes
  const int pre_w = ports * 2 * p_len;
  for (int i = threadIdx.x; i < nb * pre_w; i += blockDim.x) {
    const int b = i / pre_w, j = i - b * pre_w;
    const int q = j / p_len, t = j - q * p_len;  // q = port * 2 + plane
    dst[static_cast<size_t>(b) * row + static_cast<size_t>(q) * L + t] = c.pre[j];
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
