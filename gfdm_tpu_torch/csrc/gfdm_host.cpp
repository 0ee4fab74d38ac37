// gfdm_host: native host-side runtime for the TPU GFDM framework.
//
// The reference implements its runtime in C++ on top of the GNU Radio
// scheduler (thread-per-block, ring buffers between blocks). Here the TPU
// does all signal processing; what remains on the host is the IO-side
// runtime, implemented natively for throughput:
//
//   - wire-format conversion: interleaved sc16 IQ (USRP-style) <-> the
//     framework's planar float32 [re-plane | im-plane] layout (the
//     counterpart of /root/reference/python/pygfdm/converter.py and the
//     VOLK conversions inside the reference blocks)
//   - a single-producer stream ring buffer that frames continuous IQ into
//     fixed-size chunk batches with a lookahead halo - the role the GR
//     scheduler's ring buffers + set_output_multiple played for the
//     reference's stream blocks
//   - payload bit (un)packing for QPSK planar symbol batches
//
// Plain C ABI; Python binds via ctypes (gfdm_tpu/native).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#define GFDM_X86 1
#endif

extern "C" {

// ---------------------------------------------------------------------------
// format conversion (scalar reference + AVX2 fast path, runtime-dispatched)
// ---------------------------------------------------------------------------

static void sc16_to_planar_scalar(const int16_t* in, float* re, float* im,
                                  int64_t n, float k) {
    for (int64_t i = 0; i < n; ++i) {
        re[i] = static_cast<float>(in[2 * i]) * k;
        im[i] = static_cast<float>(in[2 * i + 1]) * k;
    }
}

#ifdef GFDM_X86
__attribute__((target("avx2")))
static void sc16_to_planar_avx2(const int16_t* in, float* re, float* im,
                                int64_t n, float k) {
    const __m256 vk = _mm256_set1_ps(k);
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        // 8 IQ pairs = 16 int16; each 32-bit lane is (Q<<16)|I
        __m256i v = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(in + 2 * i));
        __m256i vi = _mm256_srai_epi32(_mm256_slli_epi32(v, 16), 16);
        __m256i vq = _mm256_srai_epi32(v, 16);
        _mm256_storeu_ps(re + i, _mm256_mul_ps(_mm256_cvtepi32_ps(vi), vk));
        _mm256_storeu_ps(im + i, _mm256_mul_ps(_mm256_cvtepi32_ps(vq), vk));
    }
    sc16_to_planar_scalar(in + 2 * i, re + i, im + i, n - i, k);
}

__attribute__((target("avx512f,avx512bw")))
static void sc16_to_planar_avx512(const int16_t* in, float* re, float* im,
                                  int64_t n, float k) {
    const __m512 vk = _mm512_set1_ps(k);
    int64_t i = 0;
    for (; i + 16 <= n; i += 16) {
        // 16 IQ pairs = 32 int16; each 32-bit lane is (Q<<16)|I
        __m512i v = _mm512_loadu_si512(in + 2 * i);
        __m512i vi = _mm512_srai_epi32(_mm512_slli_epi32(v, 16), 16);
        __m512i vq = _mm512_srai_epi32(v, 16);
        _mm512_storeu_ps(re + i, _mm512_mul_ps(_mm512_cvtepi32_ps(vi), vk));
        _mm512_storeu_ps(im + i, _mm512_mul_ps(_mm512_cvtepi32_ps(vq), vk));
    }
    sc16_to_planar_scalar(in + 2 * i, re + i, im + i, n - i, k);
}
#endif

// Interleaved sc16 [I0,Q0,I1,Q1,...] -> planar float32 (re then im planes).
void gfdm_sc16_to_planar(const int16_t* in, float* re, float* im,
                         int64_t n_samples, float scale) {
    const float k = 1.0f / scale;
#ifdef GFDM_X86
    if (__builtin_cpu_supports("avx512f") &&
        __builtin_cpu_supports("avx512bw")) {
        sc16_to_planar_avx512(in, re, im, n_samples, k);
        return;
    }
    if (__builtin_cpu_supports("avx2")) {
        sc16_to_planar_avx2(in, re, im, n_samples, k);
        return;
    }
#endif
    sc16_to_planar_scalar(in, re, im, n_samples, k);
}

static void planar_to_sc16_scalar(const float* re, const float* im,
                                  int16_t* out, int64_t n, float scale) {
    for (int64_t i = 0; i < n; ++i) {
        float vi = re[i] * scale;
        float vq = im[i] * scale;
        vi = std::min(32767.0f, std::max(-32768.0f, std::nearbyint(vi)));
        vq = std::min(32767.0f, std::max(-32768.0f, std::nearbyint(vq)));
        out[2 * i] = static_cast<int16_t>(vi);
        out[2 * i + 1] = static_cast<int16_t>(vq);
    }
}

#ifdef GFDM_X86
__attribute__((target("avx2")))
static void planar_to_sc16_avx2(const float* re, const float* im,
                                int16_t* out, int64_t n, float scale) {
    const __m256 vs = _mm256_set1_ps(scale);
    const __m256i lo16 = _mm256_set1_epi32(0xFFFF);
    const __m256i vmin = _mm256_set1_epi32(-32768);
    const __m256i vmax = _mm256_set1_epi32(32767);
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        // cvtps_epi32 rounds to nearest-even (matches nearbyint default)
        __m256i vi = _mm256_cvtps_epi32(_mm256_mul_ps(_mm256_loadu_ps(re + i), vs));
        __m256i vq = _mm256_cvtps_epi32(_mm256_mul_ps(_mm256_loadu_ps(im + i), vs));
        vi = _mm256_min_epi32(vmax, _mm256_max_epi32(vmin, vi));
        vq = _mm256_min_epi32(vmax, _mm256_max_epi32(vmin, vq));
        __m256i packed = _mm256_or_si256(_mm256_slli_epi32(vq, 16),
                                         _mm256_and_si256(vi, lo16));
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + 2 * i), packed);
    }
    planar_to_sc16_scalar(re + i, im + i, out + 2 * i, n - i, scale);
}

__attribute__((target("avx512f,avx512bw")))
static void planar_to_sc16_avx512(const float* re, const float* im,
                                  int16_t* out, int64_t n, float scale) {
    const __m512 vs = _mm512_set1_ps(scale);
    const __m512i lo16 = _mm512_set1_epi32(0xFFFF);
    const __m512i vmin = _mm512_set1_epi32(-32768);
    const __m512i vmax = _mm512_set1_epi32(32767);
    int64_t i = 0;
    for (; i + 16 <= n; i += 16) {
        __m512i vi = _mm512_cvtps_epi32(_mm512_mul_ps(_mm512_loadu_ps(re + i), vs));
        __m512i vq = _mm512_cvtps_epi32(_mm512_mul_ps(_mm512_loadu_ps(im + i), vs));
        vi = _mm512_min_epi32(vmax, _mm512_max_epi32(vmin, vi));
        vq = _mm512_min_epi32(vmax, _mm512_max_epi32(vmin, vq));
        __m512i packed = _mm512_or_si512(_mm512_slli_epi32(vq, 16),
                                         _mm512_and_si512(vi, lo16));
        _mm512_storeu_si512(out + 2 * i, packed);
    }
    planar_to_sc16_scalar(re + i, im + i, out + 2 * i, n - i, scale);
}
#endif

// Planar float32 -> interleaved sc16 with clamping.
void gfdm_planar_to_sc16(const float* re, const float* im, int16_t* out,
                         int64_t n_samples, float scale) {
#ifdef GFDM_X86
    if (__builtin_cpu_supports("avx512f") &&
        __builtin_cpu_supports("avx512bw")) {
        planar_to_sc16_avx512(re, im, out, n_samples, scale);
        return;
    }
    if (__builtin_cpu_supports("avx2")) {
        planar_to_sc16_avx2(re, im, out, n_samples, scale);
        return;
    }
#endif
    planar_to_sc16_scalar(re, im, out, n_samples, scale);
}

// Interleaved complex float32 [re,im,...] -> planar float32.
void gfdm_cf32_to_planar(const float* in, float* re, float* im,
                         int64_t n_samples) {
    for (int64_t i = 0; i < n_samples; ++i) {
        re[i] = in[2 * i];
        im[i] = in[2 * i + 1];
    }
}

void gfdm_planar_to_cf32(const float* re, const float* im, float* out,
                         int64_t n_samples) {
    for (int64_t i = 0; i < n_samples; ++i) {
        out[2 * i] = re[i];
        out[2 * i + 1] = im[i];
    }
}

// ---------------------------------------------------------------------------
// payload bits <-> planar QPSK
// ---------------------------------------------------------------------------

// bits (0/1 bytes, layout (..., n, 2): I-bit then Q-bit) -> planar symbols
// with unit average energy ((1-2b)/sqrt(2)).
void gfdm_bits_to_qpsk_planar(const uint8_t* bits, float* re, float* im,
                              int64_t n_symbols) {
    const float a = 0.70710678118654752440f;
    for (int64_t i = 0; i < n_symbols; ++i) {
        re[i] = bits[2 * i] ? -a : a;
        im[i] = bits[2 * i + 1] ? -a : a;
    }
}

void gfdm_qpsk_planar_to_bits(const float* re, const float* im, uint8_t* bits,
                              int64_t n_symbols) {
    for (int64_t i = 0; i < n_symbols; ++i) {
        bits[2 * i] = re[i] < 0.0f ? 1 : 0;
        bits[2 * i + 1] = im[i] < 0.0f ? 1 : 0;
    }
}

// ---------------------------------------------------------------------------
// stream ring buffer with chunk framing
// ---------------------------------------------------------------------------
//
// Single-producer single-consumer. The producer pushes planar float IQ; the
// consumer pulls batches of (chunk_len + halo) extended chunks advancing by
// chunk_len per chunk - the exact windowing gfdm_tpu.runtime.stream uses, so
// a radio thread can feed the TPU without Python in the hot path.

struct GfdmStreamBuffer {
    std::vector<float> re, im;   // circular storage
    int64_t capacity = 0;
    std::atomic<int64_t> head{0};  // absolute write position (samples)
    std::atomic<int64_t> tail{0};  // absolute read position (chunk-aligned)
    int64_t chunk_len = 0;
    int64_t halo = 0;
    std::atomic<int64_t> dropped{0};
};

void* gfdm_stream_create(int64_t capacity, int64_t chunk_len, int64_t halo) {
    auto* b = new GfdmStreamBuffer();
    // round capacity up to a multiple of chunk_len for clean wrap handling
    b->capacity = ((capacity + chunk_len - 1) / chunk_len) * chunk_len;
    b->re.assign(static_cast<size_t>(b->capacity), 0.0f);
    b->im.assign(static_cast<size_t>(b->capacity), 0.0f);
    b->chunk_len = chunk_len;
    b->halo = halo;
    return b;
}

void gfdm_stream_destroy(void* h) { delete static_cast<GfdmStreamBuffer*>(h); }

// Copy n samples into the circular planes at absolute position `head`,
// split at the wrap boundary so the copies are straight memcpys.
static void ring_write(GfdmStreamBuffer* b, int64_t head, const float* re,
                       const float* im, int64_t n) {
    while (n > 0) {
        const int64_t pos = head % b->capacity;
        const int64_t run = std::min(n, b->capacity - pos);
        std::memcpy(b->re.data() + pos, re, static_cast<size_t>(run) * 4);
        std::memcpy(b->im.data() + pos, im, static_cast<size_t>(run) * 4);
        head += run; re += run; im += run; n -= run;
    }
}

static int64_t stream_commit(GfdmStreamBuffer* b, int64_t head, int64_t n) {
    head += n;
    // overflow: advance tail in whole chunks
    int64_t tail = b->tail.load(std::memory_order_relaxed);
    if (head - tail > b->capacity - b->halo) {
        const int64_t need = head - tail - (b->capacity - b->halo);
        const int64_t chunks = (need + b->chunk_len - 1) / b->chunk_len;
        b->tail.store(tail + chunks * b->chunk_len, std::memory_order_release);
        b->dropped.fetch_add(chunks * b->chunk_len, std::memory_order_relaxed);
    }
    b->head.store(head, std::memory_order_release);
    return b->dropped.load(std::memory_order_relaxed);
}

// Push n planar samples; drops the oldest unread chunks on overflow
// (returns number of samples dropped so far in total).
int64_t gfdm_stream_push(void* h, const float* re, const float* im, int64_t n) {
    auto* b = static_cast<GfdmStreamBuffer*>(h);
    const int64_t head = b->head.load(std::memory_order_relaxed);
    ring_write(b, head, re, im, n);
    return stream_commit(b, head, n);
}

// Fused wire-format ingest: convert interleaved sc16 and push in one pass
// (the radio thread never materializes an intermediate planar buffer).
int64_t gfdm_stream_push_sc16(void* h, const int16_t* in, int64_t n,
                              float scale) {
    auto* b = static_cast<GfdmStreamBuffer*>(h);
    const int64_t head = b->head.load(std::memory_order_relaxed);
    int64_t done = 0;
    int64_t pos_abs = head;
    while (done < n) {
        const int64_t pos = pos_abs % b->capacity;
        const int64_t run = std::min(n - done, b->capacity - pos);
        gfdm_sc16_to_planar(in + 2 * done, b->re.data() + pos,
                            b->im.data() + pos, run, scale);
        done += run; pos_abs += run;
    }
    return stream_commit(b, head, n);
}

// Cumulative count of samples dropped to overflow (and, for bank members,
// realignment) since creation. The consumer side polls this to account
// drops without being in the producer's call path.
int64_t gfdm_stream_dropped(void* h) {
    return static_cast<GfdmStreamBuffer*>(h)->dropped.load(
        std::memory_order_relaxed);
}

// Number of complete extended chunks ready to pull.
int64_t gfdm_stream_available_chunks(void* h) {
    auto* b = static_cast<GfdmStreamBuffer*>(h);
    const int64_t head = b->head.load(std::memory_order_acquire);
    const int64_t tail = b->tail.load(std::memory_order_relaxed);
    const int64_t avail = head - tail;
    if (avail < b->chunk_len + b->halo) return 0;
    return (avail - b->halo) / b->chunk_len;
}

// Pull up to max_chunks extended chunks into out_{re,im} with shape
// (n, 2, chunk_len + halo) planar layout (re plane then im plane per chunk).
// Returns the number of chunks written. ``base_offset_out`` (optional)
// receives the absolute sample index of the first pulled chunk.
int64_t gfdm_stream_pull(void* h, float* out, int64_t max_chunks,
                         int64_t* base_offset_out) {
    auto* b = static_cast<GfdmStreamBuffer*>(h);
    const int64_t n = std::min(max_chunks, gfdm_stream_available_chunks(h));
    if (n <= 0) return 0;
    const int64_t tail = b->tail.load(std::memory_order_relaxed);
    if (base_offset_out) *base_offset_out = tail;
    const int64_t ext = b->chunk_len + b->halo;
    for (int64_t c = 0; c < n; ++c) {
        float* dst_re = out + c * 2 * ext;
        float* dst_im = dst_re + ext;
        int64_t start = tail + c * b->chunk_len;
        int64_t left = ext;
        while (left > 0) {  // wrap-split memcpy instead of per-sample modulo
            const int64_t pos = start % b->capacity;
            const int64_t run = std::min(left, b->capacity - pos);
            std::memcpy(dst_re, b->re.data() + pos, static_cast<size_t>(run) * 4);
            std::memcpy(dst_im, b->im.data() + pos, static_cast<size_t>(run) * 4);
            dst_re += run; dst_im += run; start += run; left -= run;
        }
    }
    b->tail.store(tail + n * b->chunk_len, std::memory_order_release);
    return n;
}

// ---------------------------------------------------------------------------
// stream bank: one ring per RF channel, time-aligned batch pulls
// ---------------------------------------------------------------------------
//
// Multi-producer in the SDR sense: each radio channel (antenna port) owns an
// SPSC ring and pushes independently; the consumer pulls TIME-ALIGNED chunk
// batches across all channels (the layout the multi-antenna / cyclic-delay-
// diversity receiver wants). If channels drop unevenly under overflow, the
// pull realigns every channel to the latest common chunk boundary.

struct GfdmStreamBank {
    std::vector<GfdmStreamBuffer*> ch;
};

void* gfdm_bank_create(int64_t n_channels, int64_t capacity, int64_t chunk_len,
                       int64_t halo) {
    auto* bank = new GfdmStreamBank();
    for (int64_t i = 0; i < n_channels; ++i)
        bank->ch.push_back(static_cast<GfdmStreamBuffer*>(
            gfdm_stream_create(capacity, chunk_len, halo)));
    return bank;
}

void gfdm_bank_destroy(void* h) {
    auto* bank = static_cast<GfdmStreamBank*>(h);
    for (auto* b : bank->ch) delete b;
    delete bank;
}

int64_t gfdm_bank_push(void* h, int64_t channel, const float* re,
                       const float* im, int64_t n) {
    auto* bank = static_cast<GfdmStreamBank*>(h);
    return gfdm_stream_push(bank->ch[static_cast<size_t>(channel)], re, im, n);
}

int64_t gfdm_bank_push_sc16(void* h, int64_t channel, const int16_t* in,
                            int64_t n, float scale) {
    auto* bank = static_cast<GfdmStreamBank*>(h);
    return gfdm_stream_push_sc16(bank->ch[static_cast<size_t>(channel)], in, n,
                                 scale);
}

// Cumulative samples dropped across all channels of the bank.
int64_t gfdm_bank_dropped(void* h) {
    auto* bank = static_cast<GfdmStreamBank*>(h);
    int64_t total = 0;
    for (auto* b : bank->ch)
        total += b->dropped.load(std::memory_order_relaxed);
    return total;
}

// Chunks pullable at the latest common alignment across all channels.
int64_t gfdm_bank_available_chunks(void* h) {
    auto* bank = static_cast<GfdmStreamBank*>(h);
    if (bank->ch.empty()) return 0;
    int64_t t_max = 0;
    for (auto* b : bank->ch)
        t_max = std::max(t_max, b->tail.load(std::memory_order_relaxed));
    int64_t n = INT64_MAX;
    for (auto* b : bank->ch) {
        const int64_t head = b->head.load(std::memory_order_acquire);
        const int64_t avail = head - t_max;
        const int64_t c = (avail < b->chunk_len + b->halo)
                              ? 0
                              : (avail - b->halo) / b->chunk_len;
        n = std::min(n, c);
    }
    return n;
}

// Pull up to max_chunks aligned chunks from every channel. Output layout:
// (n, n_channels, 2, chunk_len + halo). Returns n; base_offset_out gets the
// absolute sample index of the first pulled chunk.
int64_t gfdm_bank_pull(void* h, float* out, int64_t max_chunks,
                       int64_t* base_offset_out) {
    auto* bank = static_cast<GfdmStreamBank*>(h);
    if (bank->ch.empty()) return 0;
    int64_t t_max = 0;
    for (auto* b : bank->ch)
        t_max = std::max(t_max, b->tail.load(std::memory_order_relaxed));
    for (auto* b : bank->ch)  // realign laggards (counts as drops)
        if (b->tail.load(std::memory_order_relaxed) < t_max) {
            b->dropped.fetch_add(
                t_max - b->tail.load(std::memory_order_relaxed),
                std::memory_order_relaxed);
            b->tail.store(t_max, std::memory_order_release);
        }
    const int64_t n = std::min(max_chunks, gfdm_bank_available_chunks(h));
    if (n <= 0) return 0;
    if (base_offset_out) *base_offset_out = t_max;
    const int64_t n_ch = static_cast<int64_t>(bank->ch.size());
    const int64_t ext = bank->ch[0]->chunk_len + bank->ch[0]->halo;
    for (int64_t c = 0; c < n_ch; ++c) {
        // per-channel pull into a strided view: chunk-major, channel inner
        std::vector<float> tmp(static_cast<size_t>(n * 2 * ext));
        int64_t base = 0;
        gfdm_stream_pull(bank->ch[static_cast<size_t>(c)], tmp.data(), n, &base);
        for (int64_t k = 0; k < n; ++k)
            std::memcpy(out + ((k * n_ch + c) * 2) * ext,
                        tmp.data() + k * 2 * ext,
                        static_cast<size_t>(2 * ext) * 4);
    }
    return n;
}

// ---------------------------------------------------------------------------
// threaded file ingest (async reader feeding a stream ring)
// ---------------------------------------------------------------------------

struct GfdmIngest {
    std::thread th;
    std::atomic<int64_t> samples{0};
    std::atomic<bool> done{false};
    std::atomic<bool> stop{false};
};

// Start a background thread that reads interleaved sc16 from `path` and
// pushes it into `stream` in `block_samples` batches (async IO ingest -
// the role a UHD recv thread or io_uring reader plays in production).
void* gfdm_ingest_start_sc16(const char* path, void* stream, float scale,
                             int64_t block_samples) {
    auto* ing = new GfdmIngest();
    std::string p(path);
    ing->th = std::thread([ing, p, stream, scale, block_samples]() {
        FILE* f = std::fopen(p.c_str(), "rb");
        if (f) {
            std::vector<int16_t> buf(static_cast<size_t>(2 * block_samples));
            size_t got;
            while ((got = std::fread(buf.data(), sizeof(int16_t),
                                     buf.size(), f)) > 0) {
                const int64_t ns = static_cast<int64_t>(got) / 2;
                gfdm_stream_push_sc16(stream, buf.data(), ns, scale);
                ing->samples.fetch_add(ns, std::memory_order_relaxed);
            }
            std::fclose(f);
        }
        ing->done.store(true, std::memory_order_release);
    });
    return ing;
}

// Start a background thread that receives interleaved sc16 IQ datagrams on
// a local UDP port and pushes them into `stream` - the NIC-ingest analogue
// of a UHD/VITA-49 recv thread (the reference's OTA demo sources samples
// from uhd_usrp_source, examples/gfdm_ota_demo.grc). A zero-length datagram
// marks end-of-stream; gfdm_ingest_request_stop() also ends the loop.
// The socket is created and bound on the CALLING thread so the port is
// guaranteed live once this returns; returns nullptr if the bind fails.
// Datagrams shorter than one sc16 sample (4 bytes) are treated as probes
// and pushed nowhere, so peers can detect the listener (via the absence of
// an ICMP port-unreachable rejection) without corrupting the stream.
void* gfdm_ingest_start_udp(uint16_t port, void* stream, float scale,
                            int64_t max_datagram_bytes) {
    int fd = ::socket(AF_INET, SOCK_DGRAM, 0);
    if (fd < 0) return nullptr;
    // No SO_REUSEADDR: UDP has no TIME_WAIT, so it would only let a second
    // listener silently share the port; a busy port must fail bind so the
    // caller sees OSError instead of a stale receiver stealing datagrams.
    timeval tv{0, 100000};  // 100 ms poll so stop requests are seen
    ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(port);
    if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
        ::close(fd);
        return nullptr;
    }
    auto* ing = new GfdmIngest();
    ing->th = std::thread([ing, fd, stream, scale, max_datagram_bytes]() {
        std::vector<int16_t> buf(static_cast<size_t>(max_datagram_bytes) / 2);
        while (!ing->stop.load(std::memory_order_acquire)) {
            const ssize_t got = ::recv(fd, buf.data(),
                                       static_cast<size_t>(max_datagram_bytes), 0);
            if (got == 0) break;    // explicit end-of-stream marker
            if (got < 0) continue;  // timeout: re-check stop flag
            const int64_t ns = static_cast<int64_t>(got) / 4;
            if (ns > 0) {
                gfdm_stream_push_sc16(stream, buf.data(), ns, scale);
                ing->samples.fetch_add(ns, std::memory_order_relaxed);
            }
        }
        ::close(fd);
        ing->done.store(true, std::memory_order_release);
    });
    return ing;
}

// Ask a UDP ingest loop to exit (takes effect within one poll interval).
void gfdm_ingest_request_stop(void* h) {
    static_cast<GfdmIngest*>(h)->stop.store(true, std::memory_order_release);
}

// -1 while running, else total samples ingested.
int64_t gfdm_ingest_poll(void* h) {
    auto* ing = static_cast<GfdmIngest*>(h);
    if (!ing->done.load(std::memory_order_acquire)) return -1;
    return ing->samples.load(std::memory_order_relaxed);
}

// Join the reader thread and free the handle; returns total samples.
int64_t gfdm_ingest_finish(void* h) {
    auto* ing = static_cast<GfdmIngest*>(h);
    if (ing->th.joinable()) ing->th.join();
    const int64_t n = ing->samples.load(std::memory_order_relaxed);
    delete ing;
    return n;
}

}  // extern "C"
