// Fused GFDM transmitter for Hopper (sm_90a), one port or every CDD port.
//
// Replaces the Pallas kernels gfdm_tpu/kernels/fused.py::_tx_kernel
// (wrapper tx_frame_fused: one cyclic shift) and ::_tx_cdd_kernel (wrapper
// tx_cdd_fused: every cyclic-delay-diversity port): payload (B, 2 n_data)
// -> Gauss 3-product with T_G = [Wr; Wi; Wr+Wi] (map + modulate folded in)
//      p1 = xr @ Wr, p2 = xi @ Wi, p3 = (xr + xi) @ (Wr + Wi),
//      core = (p1 - p2, (p3 - p1) - p2)
// -> for each port p at cyclic shift s_p, framed[i] = core[(i - cp - s_p)
// mod N] * win[i] (0 <= i < cp + N + cs) -> its planar preamble in front
// -> bursts (B, n_ports, 2 frame_len).
//
// Bound (H100 SXM): 3 n_data N fp32 MACs a burst, 1.06e11 operations at
// B = 65,536 and the canonical config (n_data = 468, N = 576): 1.582 ms at
// the 67 TFLOP/s of fp32 FMA. The bytes (payload in, bursts out, T_G once)
// take 0.19 ms for one port and 0.31 ms for two: operation-bound.
//
// Why FMA on the CUDA cores and not tensor cores: 3xTF32 changes the
// burst's bits (and the link's 3xTF32 wmma engine sat at 12.9% of its
// bound), the FP64 tensor cores peak at the same 67 TFLOP/s as fp32 FMA,
// and bf16 is not the function the Tx computes.
//
// Design: a register-blocked GEMM over (bursts x core columns) output tiles,
// TX_BM x TX_BN = 64 x 64, one CTA of 128 threads each, three CTAs an SM,
// column tile fastest (the CTAs in flight share their payload rows in L2; T_G,
// 3.2 MB at the canonical config, leaves L2 once a 64-burst tile). k runs in
// TX_BK = 16-deep k-tiles through a two-slot cp.async ring: a slot holds xr's
// and xi's (64 x 16) slabs [row][k] and the three T_G planes' (16 x 64) slabs
// [k][col]. The copies are 16 bytes where every operand's base, pitch and plane
// offset allows, else 8 or 4 (n_data = 130 puts xi 520 bytes into a row); a
// ragged k-tile, rows past B and columns past N are zero-filled by the copy's
// src-size. Each payload slab is transposed once in shared memory to [k][row],
// so a thread reads the 8 rows it keeps (8 ty .. 8 ty + 7) of one k as two
// 16-byte loads a plane; with its 4 columns (4 tx .. 4 tx + 3) of the three T_G
// planes, 7 16-byte shared loads and 8 adds (s = xr + xi, one float32 add of
// the loaded operands) feed 96 FMAs, the three products' 96 sums in registers.
// Three CTAs an SM cap a thread at 168 registers and ptxas spills about 0.2 KB
// a thread; that ran faster than two CTAs an SM without spills, and than a
// three-slot ring with one barrier a k-tile (more spills). Every sum is one FMA
// chain over k in order from zero, no split-k, as cuBLAS's SGEMM sums at these
// shapes: the bursts are bit-equal to the plain version's. The epilogue parks
// the core tile in the ring's shared memory; a thread keeps one column and, for
// every port, writes each of its samples to the 1-3 framed positions (the body;
// the CP copy where col >= N - cp - s_p; the CS copy where col < cs - s_p)
// times their window factors, warps on consecutive columns; the column-0 tiles
// write the preambles.
#include "gfdm_common.cuh"

namespace gfdm {
namespace tx {

constexpr int TX_BM = 64, TX_BN = 64, TX_BK = 16, TX_STAGES = 2, TX_THREADS = 128;
constexpr int TX_TM = 8, TX_TN = 4;  // a thread's block: rows 8 ty + i, columns 4 tx + j
constexpr int TX_TX = TX_BN / TX_TN;  // 16 column groups
static_assert(TX_BM == (TX_THREADS / TX_TX) * TX_TM && TX_BK == 16 && TX_BM == 64 &&
                  TX_TM == 8 && TX_TN == 4,
              "Tx tiling: the slab's swizzle, the transpose and the float4 operands");
constexpr int A_FLOATS = TX_BM * TX_BK;  // one payload plane's slab (and its transpose)
constexpr int W_FLOATS = TX_BK * TX_BN;  // one T_G plane's slab
constexpr int SLOT = 2 * A_FLOATS + 3 * W_FLOATS;
constexpr int LDC = TX_BN + 4;           // the core tile's row pitch (16-byte rows)
static_assert(2 * TX_BM * LDC <= TX_STAGES * SLOT, "the core tile fits the ring");
// the ring, then the payload slab's xr and xi transposed to [k][row]
constexpr size_t TX_SMEM = sizeof(float) * (TX_STAGES * SLOT + 2 * A_FLOATS);

// VEC floats global -> shared, or zeros where !valid (src-size 0 reads
// nothing); 16 bytes through L2 only, 8 and 4 through L1
template <int VEC>
__device__ __forceinline__ void cp_async_zfill(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                 "n"(4 * VEC), "r"(valid ? 4 * VEC : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// Payload slab element (row r, k) of a plane: its 16-byte k-chunk XOR-ed by
// (r / 2) % 4, so that the transpose's 16-byte reads of 8 consecutive rows
// fall in 8 different bank groups.
__device__ __forceinline__ int a_at(int r, int k) {
  return r * TX_BK + (((k >> 2) ^ ((r >> 1) & 3)) << 2) + (k & 3);
}

// k-tile k0 into a ring slot: payload rows row0 .. row0 + 64 (both planes)
// and T_G rows k0 .. k0 + 16 of each plane, columns col0 .. col0 + 64.
// n_data and N are multiples of VEC, so a copy is wholly in or out.
template <int VEC>
__device__ __forceinline__ void load_slot(float* slot, const Dims& d, const float* data,
                                          const float* tg, int row0, int nb, int col0,
                                          int k0, int tid) {
  constexpr int AC = TX_BK / VEC;  // copies a payload row of the slab
#pragma unroll
  for (int i = 0; i < 2 * A_FLOATS / VEC / TX_THREADS; ++i) {
    const int c = tid + i * TX_THREADS;
    const int q = c / (A_FLOATS / VEC), rem = c - q * (A_FLOATS / VEC);
    const int r = rem / AC, kk = (rem - r * AC) * VEC, k = k0 + kk;
    const bool ok = r < nb && k < d.n_data;
    const float* src =
        ok ? data + static_cast<size_t>(row0 + r) * 2 * d.n_data + q * d.n_data + k : data;
    cp_async_zfill<VEC>(slot + q * A_FLOATS + a_at(r, kk), src, ok);
  }
  constexpr int WC = TX_BN / VEC;  // copies a T_G row of the slab
  float* ws = slot + 2 * A_FLOATS;
#pragma unroll
  for (int i = 0; i < 3 * W_FLOATS / VEC / TX_THREADS; ++i) {
    const int c = tid + i * TX_THREADS;
    const int q = c / (W_FLOATS / VEC), rem = c - q * (W_FLOATS / VEC);
    const int r = rem / WC, cc = (rem - r * WC) * VEC;
    const int k = k0 + r, col = col0 + cc;
    const bool ok = k < d.n_data && col < d.n;
    const float* src =
        ok ? tg + (static_cast<size_t>(q) * d.n_data + k) * d.n + col : tg;
    cp_async_zfill<VEC>(ws + q * W_FLOATS + r * TX_BN + cc, src, ok);
  }
}

template <int VEC>
__global__ void __launch_bounds__(TX_THREADS, 3)
tx_kernel(Dims d, Consts c, const float* __restrict__ data, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* tr = smem + TX_STAGES * SLOT;  // [k][row] planes xr, xi
  const int tid = threadIdx.x, tx = tid % TX_TX, ty = tid / TX_TX;
  const int n_ct = (d.n + TX_BN - 1) / TX_BN;
  const int ct = blockIdx.x % n_ct;
  const int row0 = (blockIdx.x / n_ct) * TX_BM, col0 = ct * TX_BN;
  const int nb = min(TX_BM, d.batch - row0);
  const float* tg = static_cast<const float*>(c.t_g);
  const int nt = (d.n_data + TX_BK - 1) / TX_BK;

  float p1[TX_TM][TX_TN], p2[TX_TM][TX_TN], p3[TX_TM][TX_TN];
#pragma unroll
  for (int i = 0; i < TX_TM; ++i)
#pragma unroll
    for (int j = 0; j < TX_TN; ++j) p1[i][j] = p2[i][j] = p3[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < TX_STAGES - 1; ++s) {
    if (s < nt) load_slot<VEC>(smem + s * SLOT, d, data, tg, row0, nb, col0, s * TX_BK, tid);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<TX_STAGES - 2>();  // k-tile t has landed
    __syncthreads();  // ... for every thread; k-tile t - 1's slot and the transpose are free
    // k-tile t + 1 into the other slot while t is transposed and multiplied
    const int tn = t + TX_STAGES - 1;
    if (tn < nt) {
      load_slot<VEC>(smem + (tn % TX_STAGES) * SLOT, d, data, tg, row0, nb, col0, tn * TX_BK,
                     tid);
    }
    cp_async_commit();
    const float* slot = smem + (t % TX_STAGES) * SLOT;
    {  // transpose: row r, k 8 h .. 8 h + 7 of xr and xi
      const int r = tid % TX_BM, h = tid / TX_BM;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int at = a_at(r, 8 * h + 4 * u);
        const float4 a = *reinterpret_cast<const float4*>(slot + at);
        const float4 b = *reinterpret_cast<const float4*>(slot + A_FLOATS + at);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* col = tr + (8 * h + 4 * u + e) * TX_BM + r;
          col[0] = lane4(a, e);
          col[A_FLOATS] = lane4(b, e);
        }
      }
    }
    __syncthreads();
    const float* w = slot + 2 * A_FLOATS;
#pragma unroll
    for (int k = 0; k < TX_BK; ++k) {
      // rows 8 ty .. 8 ty + 7 of k: a warp reads two 32-byte runs, broadcast
      const float4* xk = reinterpret_cast<const float4*>(tr + k * TX_BM + TX_TM * ty);
      const float4 a[2] = {xk[0], xk[1]};
      const float4 b[2] = {xk[A_FLOATS / 4], xk[A_FLOATS / 4 + 1]};
      const float* wk = w + k * TX_BN + TX_TN * tx;
      const float4 w1 = *reinterpret_cast<const float4*>(wk);
      const float4 w2 = *reinterpret_cast<const float4*>(wk + W_FLOATS);
      const float4 w3 = *reinterpret_cast<const float4*>(wk + 2 * W_FLOATS);
#pragma unroll
      for (int i = 0; i < TX_TM; ++i) {
        const float ai = lane4(a[i / 4], i % 4), bi = lane4(b[i / 4], i % 4);
        const float si = ai + bi;
#pragma unroll
        for (int j = 0; j < TX_TN; ++j) p1[i][j] = fmaf(ai, lane4(w1, j), p1[i][j]);
#pragma unroll
        for (int j = 0; j < TX_TN; ++j) p2[i][j] = fmaf(bi, lane4(w2, j), p2[i][j]);
#pragma unroll
        for (int j = 0; j < TX_TN; ++j) p3[i][j] = fmaf(si, lane4(w3, j), p3[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is past its last k-tile: the ring is free

  // the core tile (re, im planes, 64 x 64) into the ring's shared memory
  float* core = smem;
#pragma unroll
  for (int i = 0; i < TX_TM; ++i) {
    float yr[TX_TN], yi[TX_TN];
#pragma unroll
    for (int j = 0; j < TX_TN; ++j) {
      yr[j] = p1[i][j] - p2[i][j];
      yi[j] = (p3[i][j] - p1[i][j]) - p2[i][j];
    }
    float* cr = core + (TX_TM * ty + i) * LDC + TX_TN * tx;
    *reinterpret_cast<float4*>(cr) = make_float4(yr[0], yr[1], yr[2], yr[3]);
    *reinterpret_cast<float4*>(cr + TX_BM * LDC) = make_float4(yi[0], yi[1], yi[2], yi[3]);
  }
  __syncthreads();

  // each core sample to its framed positions in every port: a thread keeps
  // one column (so its window factors) and walks the rows and planes
  const int n = d.n, L = d.frame_len, ports = d.n_ports;
  const size_t row_len = static_cast<size_t>(ports) * 2 * L;  // one burst, all ports
  const int cc = tid % TX_BN, col = col0 + cc;
  if (col < n) {
    const float* cv = core + cc;
    for (int port = 0; port < ports; ++port) {
      const int shift = __ldg(c.shifts + port);
      const int lead = d.cp_len + shift;  // framed position of core sample 0
      // the body; the CP copy where col >= N - lead; the CS copy where col < cs - shift
      const int i_body = col + lead, i_cp = col - (n - lead), i_cs = col + lead + n;
      const bool cp = i_cp >= 0, cs = col < d.cs_len - shift;
      const float w_body = __ldg(c.win + i_body);
      const float w_cp = cp ? __ldg(c.win + i_cp) : 0.f;
      const float w_cs = cs ? __ldg(c.win + i_cs) : 0.f;
      float* dst = out + static_cast<size_t>(row0) * row_len + static_cast<size_t>(port) * 2 * L +
                   d.preamble_len;
#pragma unroll 4
      for (int rq = tid / TX_BN; rq < 2 * nb; rq += TX_THREADS / TX_BN) {
        const int r = rq >> 1, q = rq & 1;  // row, plane
        const float v = cv[(q * TX_BM + r) * LDC];
        float* f = dst + static_cast<size_t>(r) * row_len + q * L;
        f[i_body] = v * w_body;
        if (cp) f[i_cp] = v * w_cp;
        if (cs) f[i_cs] = v * w_cs;
      }
    }
  }
  // preambles: port p's planar (2, p_len) row heads its two planes
  if (ct == 0) {
    const int p_len = d.preamble_len, pre_w = ports * 2 * p_len;
    float* rows = out + static_cast<size_t>(row0) * row_len;
    for (int i = tid; i < nb * pre_w; i += TX_THREADS) {
      const int b = i / pre_w, j = i - b * pre_w;
      const int qq = j / p_len, t = j - qq * p_len;  // qq = port * 2 + plane
      rows[static_cast<size_t>(b) * row_len + static_cast<size_t>(qq) * L + t] = __ldg(c.pre + j);
    }
  }
}

template <int VEC>
int launch(const Dims* d, const Consts* c, const float* data, float* out, void* stream) {
  (void)cudaGetLastError();  // report this launch's error only (earlier calls reported theirs)
  cudaError_t err = cudaFuncSetAttribute(
      tx_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(TX_SMEM));
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // a refused launch leaves no error behind
    return static_cast<int>(err);
  }
  const int tiles = ((d->n + TX_BN - 1) / TX_BN) * ((d->batch + TX_BM - 1) / TX_BM);
  tx_kernel<VEC><<<tiles, TX_THREADS, TX_SMEM,
                   static_cast<cudaStream_t>(stream)>>>(*d, *c, data, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tx
}  // namespace gfdm

extern "C" int gfdm_tx(const gfdm::Dims* d, const gfdm::Consts* c,
                       const float* data, float* out, void* stream) {
  if (d->batch <= 0) return 0;
  // the widest copy every operand's base, row pitch and plane offset allow
  const auto fits = [&](int v) {
    return d->n_data % v == 0 && d->n % v == 0 &&
           reinterpret_cast<uintptr_t>(data) % (4 * v) == 0 &&
           reinterpret_cast<uintptr_t>(c->t_g) % (4 * v) == 0;
  };
  if (fits(4)) return gfdm::tx::launch<4>(d, c, data, out, stream);
  if (fits(2)) return gfdm::tx::launch<2>(d, c, data, out, stream);
  return gfdm::tx::launch<1>(d, c, data, out, stream);
}

// The Tx tile: bursts, core columns and k-depth of a CTA, and its shared
// memory in bytes (kernels/fused.py TX_TILE)
extern "C" int gfdm_tx_tile(int* out) {
  out[0] = gfdm::tx::TX_BM;
  out[1] = gfdm::tx::TX_BN;
  out[2] = gfdm::tx::TX_BK;
  out[3] = static_cast<int>(gfdm::tx::TX_SMEM);
  return 0;
}
