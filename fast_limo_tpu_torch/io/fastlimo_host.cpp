// Host-side native runtime of fast_limo_tpu_torch (the port's copy of the
// ring buffer and the int16 scan packer of the JAX package's host runtime,
// csrc/fastlimo_host.cpp; the KITTI parser and the filter chain are not
// used by the port and are not copied).
//
//  * a lock-free SPSC ring buffer for sensor ingestion threads
//    (io/stream.AsyncIngest)
//  * the one-pass int16 scan packer of the quantized transfer
//    (models/localizer._pack_points with tpu.quantize_transfer > 0)
//
// Exposed as a plain C ABI for ctypes; built with g++ by io/native.py.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// lock-free SPSC byte ring (sensor ingestion thread → dispatch thread)
// ---------------------------------------------------------------------------

struct FlhRing {
  uint8_t* data;
  uint64_t capacity;   // power of two
  uint64_t item_size;
  std::atomic<uint64_t> head;  // producer writes
  std::atomic<uint64_t> tail;  // consumer reads
};

void* flh_ring_create(uint64_t n_items, uint64_t item_size) {
  // round up to power of two
  uint64_t cap = 1;
  while (cap < n_items) cap <<= 1;
  FlhRing* r = new FlhRing();
  r->data = new uint8_t[cap * item_size];
  r->capacity = cap;
  r->item_size = item_size;
  r->head.store(0);
  r->tail.store(0);
  return r;
}

void flh_ring_destroy(void* ring) {
  FlhRing* r = (FlhRing*)ring;
  delete[] r->data;
  delete r;
}

int flh_ring_push(void* ring, const void* item) {
  FlhRing* r = (FlhRing*)ring;
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->capacity) return 0;  // full
  std::memcpy(r->data + (head & (r->capacity - 1)) * r->item_size, item,
              r->item_size);
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

int flh_ring_pop(void* ring, void* item) {
  FlhRing* r = (FlhRing*)ring;
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  if (tail == head) return 0;  // empty
  std::memcpy(item, r->data + (tail & (r->capacity - 1)) * r->item_size,
              r->item_size);
  r->tail.store(tail + 1, std::memory_order_release);
  return 1;
}

// ---------------------------------------------------------------------------
// one-pass int16 scan packing for the transfer-minimal dispatch path
// (Localizer._pack_points with tpu.quantize_transfer > 0): quantize xyz by
// `quant` metres/LSB, pick t_scale = max|t_raw|/32767, quantize t_raw by it.
// One pass in place of a 4-op NumPy chain (pack_scan_i16_numpy).
// out is (n_cap, 4) int16 rows [x, y, z, t], zero-padded past n.
// Rounding matches np.rint (round-half-to-even = default FP environment).
// std::rint rounds as std::nearbyint does, but nearbyint must leave the
// inexact flag clear, and glibc saves and restores the FP environment on
// every call for that, which made this pass slower than the NumPy twin.
// ---------------------------------------------------------------------------

int64_t flh_pack_scan_i16(const float* xyz, const float* t_raw, int64_t n,
                          float quant, int16_t* out, int64_t n_cap,
                          float* t_scale_out) {
  if (n > n_cap) n = n_cap;
  float tmax = 0.f;
  for (int64_t i = 0; i < n; i++) {
    const float a = std::fabs(t_raw[i]);
    if (a > tmax) tmax = a;
  }
  // All quantization products are computed in DOUBLE: an f64 multiply is
  // IEEE-identical between any compiler and NumPy, so the NumPy fallback
  // (io/native.py pack_scan_i16_numpy) is bit-identical to this path —
  // f32 products can land exactly on .5 ties whose resolution depends on
  // how the compiler schedules the multiply (observed 1-LSB divergence).
  const float ts = (float)(std::max((double)tmax, 1e-12) / 32767.0);
  const double inv_q = 1.0 / (double)quant;
  const double inv_ts = 1.0 / (double)ts;
  for (int64_t i = 0; i < n; i++) {
    for (int c = 0; c < 3; c++) {
      double v = std::rint((double)xyz[i * 3 + c] * inv_q);
      v = std::min(32767.0, std::max(-32767.0, v));
      out[i * 4 + c] = (int16_t)v;
    }
    double tv = std::rint((double)t_raw[i] * inv_ts);
    tv = std::min(32767.0, std::max(-32767.0, tv));
    out[i * 4 + 3] = (int16_t)tv;
  }
  std::memset(out + n * 4, 0, sizeof(int16_t) * 4 * (size_t)(n_cap - n));
  *t_scale_out = ts;
  return n;
}

uint64_t flh_ring_size(void* ring) {
  FlhRing* r = (FlhRing*)ring;
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

}  // extern "C"
