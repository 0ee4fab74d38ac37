// Shared device code of the GFDM kernels (rx.cu, link.cu, factored.cu; tx.cu
// takes Dims and Consts only).
//
// Layouts follow the planar convention of the Python package: a complex
// row of length n is the real row [re | im] of length 2n; a complex operator
// W (n_in, n_out) is the Gauss stack [Wr; Wi; Wr+Wi] of shape (3 n_in, n_out),
// row-major, in float32 or (the link's dtype "bfloat16") as bf16 bits.
//
// The staged receiver's and link's options are runtime fields of Dims read
// by link.cu's stages; the superseded receivers (rx.cu) run ZF and circulant
// QPSK IC.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gfdm {

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

}  // namespace gfdm
