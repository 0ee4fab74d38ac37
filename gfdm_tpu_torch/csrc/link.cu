// One-kernel GFDM loopback link for Hopper (sm_90a).
//
// Replaces the Pallas kernel gfdm_tpu/kernels/fused.py::_link_kernel
// (wrapper link_single_fused): payload (B, 2 n_data) -> the transmitter of
// tx.cu at cyclic shift 0 -> the receiver of rx.cu (ZF; QPSK, qam16 or qam64
// IC decisions; either IC mode) -> demap -> data estimate (B, 2 n_data) and
// metrics (B, met_w). EVM is reduced outside the kernel. With dtype
// "bfloat16" (Dims::bf16) the five Gauss stacks are bf16 and every
// activation is rounded to bf16 before its product, the sum plane's
// xr + xi too (the JAX package's _gdot); accumulation stays f32. That is the
// W = uint16_t instantiation.
//
// Bound: the sum of the two chains, 3.1 M fp32 MACs a burst plus 1.0 M per
// matmul-mode IC iteration, against 3.7 KB read and 4.2 KB written: FMA-bound,
// with about 14 MB of operator stacks (7 MB in bf16) streamed from L2 once
// per tile. Design: the burst never reaches HBM. The Tx epilogue writes the
// windowed core straight into the receiver's payload window in shared
// memory, and the receiver's preamble window is the transmitted preamble
// itself; the demap is a gather in place of the 0/1 selection matmul.
#include "gfdm_common.cuh"

namespace gfdm {

template <int TB, typename W>
__global__ void __launch_bounds__(MAX_THREADS)
link_kernel(Dims d, Consts c, const float* __restrict__ data,
            float* __restrict__ out, float* __restrict__ met) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * TB;
  const int nb = min(TB, d.batch - b0);
  const int n = d.n, half = d.half, w = 2 * n, n_d = d.n_data;
  float* P = smem;
  float* F = P + TB * 2 * half;
  float* X = F + 2 * TB * w;  // the payload tile is staged in the X stage
  load_tile<TB>(X, data + static_cast<size_t>(b0) * 2 * n_d, n_d, nb);
  for (int i = threadIdx.x; i < TB * 2 * half; i += blockDim.x) {
    const int j = i % (2 * half);
    const int p = j / half, t = j - p * half;
    P[i] = c.pre[p * d.preamble_len + d.cp_len + t];
  }
  __syncthreads();
  // Tx at shift 0: core sample col sits at framed position cp + col, so the
  // payload window [fs, fs + N) of the burst is core * win[cp:cp + N]
  tx_core<TB, W>(d, c, X, [&](int b, int col, float cr, float ci) {
    const float wv = c.win[d.cp_len + col];
    F[b * w + col] = cr * wv;
    F[b * w + n + col] = ci * wv;
  });
  __syncthreads();
  const float* s = rx_chain<TB, W>(d, c, smem, nb, nullptr,
                            met + static_cast<size_t>(b0) * d.met_w);
  float* o = out + static_cast<size_t>(b0) * 2 * n_d;
  for (int i = threadIdx.x; i < nb * 2 * n_d; i += blockDim.x) {
    const int b = i / (2 * n_d), j = i - b * 2 * n_d;
    const int p = j / n_d, t = j - p * n_d;
    o[i] = s[b * w + p * n + c.demap_idx[t]];
  }
}

template <int TB, typename W>
int launch_link(const Dims* d, const Consts* c, const float* data, float* out,
                float* met, void* stream) {
  const size_t smem = sizeof(float) * rx_smem_floats(*d, TB);
  cudaError_t err = cudaFuncSetAttribute(
      link_kernel<TB, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (d->batch + TB - 1) / TB;
  link_kernel<TB, W><<<blocks, block_threads(*d), smem,
                       static_cast<cudaStream_t>(stream)>>>(*d, *c, data, out, met);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_link_tile(const Dims* d, const Consts* c, const float* data, float* out,
                     float* met, void* stream) {
  switch (rx_tile_bursts(*d)) {
    case 8: return launch_link<8, W>(d, c, data, out, met, stream);
    case 4: return launch_link<4, W>(d, c, data, out, met, stream);
    case 2: return launch_link<2, W>(d, c, data, out, met, stream);
    default: return launch_link<1, W>(d, c, data, out, met, stream);
  }
}

}  // namespace gfdm

// The receiver's tile (rx_tile_bursts); a config whose one-burst tile
// exceeds shared memory runs the TB = 1 launch, which the runtime refuses.
extern "C" int gfdm_link(const gfdm::Dims* d, const gfdm::Consts* c,
                         const float* data, float* out, float* met,
                         void* stream) {
  if (d->batch <= 0) return 0;
  return d->bf16 ? gfdm::launch_link_tile<uint16_t>(d, c, data, out, met, stream)
                 : gfdm::launch_link_tile<float>(d, c, data, out, met, stream);
}

extern "C" const char* gfdm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bursts a receiver / link CTA takes on the current device (0: none fits).
extern "C" int gfdm_rx_tile_bursts(const gfdm::Dims* d) {
  return gfdm::rx_tile_bursts(*d);
}

// Shared memory of the receiver / link launch: the chosen tile, or one
// burst where none fits.
extern "C" size_t gfdm_rx_smem_bytes(const gfdm::Dims* d) {
  const int tb = gfdm::rx_tile_bursts(*d);
  return sizeof(float) * gfdm::rx_smem_floats(*d, tb > 0 ? tb : 1);
}

extern "C" int gfdm_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(gfdm::Dims));
  out[1] = static_cast<int>(sizeof(gfdm::Consts));
  return 0;
}
