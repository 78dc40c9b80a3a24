// Native host runtime for dumphfdl-tpu.
//
// The reference implements its host runtime in C (pthread ring buffers in
// src/block.c, sample converters in src/input-helpers.c).  This library
// provides this framework's equivalents: a lock-free single-producer/
// single-consumer sample ring for live SDR ingest, and vectorizable
// CU8/CS16 -> float32 converters with the reference's scaling
// (input-helpers.c:94-126).  Exposed via a plain C ABI for ctypes.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

// ---------------------------------------------------------------------------
// Sample format converters (complex interleaved I/Q)
// ---------------------------------------------------------------------------

// CU8: (byte - 63.5) / 127  (input-helpers.c:56-78)
void hfdl_convert_cu8(const uint8_t *in, float *out, int64_t n_values) {
    static float lut[256];
    static bool lut_init = false;
    if (!lut_init) {
        for (int i = 0; i < 256; i++) {
            lut[i] = (static_cast<float>(i) - 63.5f) / 127.0f;
        }
        lut_init = true;
    }
    for (int64_t i = 0; i < n_values; i++) {
        out[i] = lut[in[i]];
    }
}

// CS16 little-endian: value / 32767.5  (input-helpers.c:33-54)
void hfdl_convert_cs16(const int16_t *in, float *out, int64_t n_values) {
    constexpr float kScale = 1.0f / 32767.5f;
    for (int64_t i = 0; i < n_values; i++) {
        out[i] = static_cast<float>(in[i]) * kScale;
    }
}

// ---------------------------------------------------------------------------
// Lock-free SPSC ring buffer of complex64 samples (2 floats each).
// Equivalent role: liquid cbuffercf + mutex/condvar in src/block.c:15-33,
// redesigned lock-free so the SDR reader thread never blocks the feeder.
// ---------------------------------------------------------------------------

struct HfdlRing {
    float *data;                  // interleaved I/Q
    int64_t capacity;             // samples (power of two)
    std::atomic<int64_t> head;    // write index (samples)
    std::atomic<int64_t> tail;    // read index (samples)
    std::atomic<int64_t> overruns;
};

static int64_t next_pow2_i64(int64_t x) {
    int64_t p = 1;
    while (p < x) p <<= 1;
    return p;
}

HfdlRing *hfdl_ring_create(int64_t capacity_samples) {
    auto *r = new (std::nothrow) HfdlRing();
    if (!r) return nullptr;
    r->capacity = next_pow2_i64(capacity_samples);
    r->data = new (std::nothrow) float[2 * r->capacity];
    if (!r->data) {
        delete r;
        return nullptr;
    }
    r->head.store(0);
    r->tail.store(0);
    r->overruns.store(0);
    return r;
}

void hfdl_ring_destroy(HfdlRing *r) {
    if (r) {
        delete[] r->data;
        delete r;
    }
}

int64_t hfdl_ring_size(const HfdlRing *r) {
    return r->head.load(std::memory_order_acquire)
         - r->tail.load(std::memory_order_acquire);
}

int64_t hfdl_ring_space(const HfdlRing *r) {
    return r->capacity - hfdl_ring_size(r);
}

int64_t hfdl_ring_overruns(const HfdlRing *r) {
    return r->overruns.load(std::memory_order_relaxed);
}

// Write n samples; returns samples written (drops the excess and counts
// it as an overrun, like complex_samples_produce, input-helpers.c:80-92).
int64_t hfdl_ring_write(HfdlRing *r, const float *iq, int64_t n) {
    int64_t head = r->head.load(std::memory_order_relaxed);
    int64_t tail = r->tail.load(std::memory_order_acquire);
    int64_t space = r->capacity - (head - tail);
    if (n > space) {
        r->overruns.fetch_add(n - space, std::memory_order_relaxed);
        n = space;
    }
    const int64_t mask = r->capacity - 1;
    for (int64_t i = 0; i < n; i++) {
        int64_t idx = (head + i) & mask;
        r->data[2 * idx] = iq[2 * i];
        r->data[2 * idx + 1] = iq[2 * i + 1];
    }
    r->head.store(head + n, std::memory_order_release);
    return n;
}

// Read up to n samples; returns samples read.
int64_t hfdl_ring_read(HfdlRing *r, float *iq, int64_t n) {
    int64_t tail = r->tail.load(std::memory_order_relaxed);
    int64_t head = r->head.load(std::memory_order_acquire);
    int64_t avail = head - tail;
    if (n > avail) n = avail;
    const int64_t mask = r->capacity - 1;
    for (int64_t i = 0; i < n; i++) {
        int64_t idx = (tail + i) & mask;
        iq[2 * i] = r->data[2 * idx];
        iq[2 * i + 1] = r->data[2 * idx + 1];
    }
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

}  // extern "C"
