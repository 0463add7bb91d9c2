// Range coder over per-symbol quantized CDF rows: the port's own copy of the
// JAX package's csrc/range_coder.cpp, with the same C interface (rc_encode,
// rc_decode, rc_encode_shared, rc_decode_shared) and the same bytes.
//
// Each coded value carries its own CDF row, quantized to 16-bit precision by
// compression/coder.py::quantize_cdf. Carry handling follows the classic
// LZMA-style 64-bit-low range encoder; the decoder does a per-symbol binary
// search over its CDF row.
//
// Built on first use by compression/coder.py with the host C++ compiler:
//   c++ -O3 -shared -fPIC -o librange_coder.so range_coder.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr uint32_t kTotalBits = 16;

struct Encoder {
  std::vector<uint8_t> out;
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  uint64_t cache_size = 1;

  void shift_low() {
    if ((uint32_t)low < 0xFF000000u || (low >> 32) != 0) {
      uint8_t carry = (uint8_t)(low >> 32);
      uint8_t temp = cache;
      do {
        out.push_back((uint8_t)(temp + carry));
        temp = 0xFF;
      } while (--cache_size != 0);
      cache = (uint8_t)(low >> 24);
    }
    cache_size++;
    low = (uint32_t)low << 8;
  }

  void encode(uint32_t start, uint32_t size) {
    range >>= kTotalBits;
    low += (uint64_t)start * range;
    range *= size;
    while (range < kTop) {
      range <<= 8;
      shift_low();
    }
  }

  void flush() {
    for (int i = 0; i < 5; i++) shift_low();
  }
};

struct Decoder {
  const uint8_t* in;
  int64_t pos = 0, len = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;

  uint8_t read_byte() { return pos < len ? in[pos++] : 0; }

  void init(const uint8_t* data, int64_t n) {
    in = data;
    len = n;
    code = 0;
    range = 0xFFFFFFFFu;
    for (int i = 0; i < 5; i++) code = (code << 8) | read_byte();
  }

  uint32_t threshold() {
    range >>= kTotalBits;
    uint32_t t = code / range;
    return t < (1u << kTotalBits) ? t : (1u << kTotalBits) - 1;
  }

  void consume(uint32_t start, uint32_t size) {
    code -= start * range;
    range *= size;
    while (range < kTop) {
      code = (code << 8) | read_byte();
      range <<= 8;
    }
  }
};

}  // namespace

extern "C" {

// cdf: [n, s_plus_1] uint16 rows, monotonically increasing, row[0]==0 and a
// conceptual row[S]==65536 (stored value 0 means 65536 at the last position —
// callers instead pass strictly-increasing rows where the final entry may be
// 65535; we widen the final bin to 65536 internally).
// symbols: [n] int32 in [0, s). Returns number of bytes written to out
// (capacity cap), or -1 on overflow / invalid symbol.
int64_t rc_encode(const uint16_t* cdf, int64_t n, int64_t s_plus_1,
                  const int32_t* symbols, uint8_t* out, int64_t cap) {
  Encoder enc;
  const int64_t s = s_plus_1 - 1;
  for (int64_t i = 0; i < n; i++) {
    int32_t sym = symbols[i];
    if (sym < 0 || sym >= s) return -1;
    const uint16_t* row = cdf + i * s_plus_1;
    uint32_t lo = row[sym];
    uint32_t hi = (sym == s - 1) ? (1u << kTotalBits) : row[sym + 1];
    if (hi <= lo) return -1;
    enc.encode(lo, hi - lo);
  }
  enc.flush();
  if ((int64_t)enc.out.size() > cap) return -1;
  std::memcpy(out, enc.out.data(), enc.out.size());
  return (int64_t)enc.out.size();
}

// Decode n symbols; returns 0 on success.
int64_t rc_decode(const uint16_t* cdf, int64_t n, int64_t s_plus_1,
                  const uint8_t* data, int64_t data_len, int32_t* symbols) {
  Decoder dec;
  dec.init(data, data_len);
  const int64_t s = s_plus_1 - 1;
  for (int64_t i = 0; i < n; i++) {
    const uint16_t* row = cdf + i * s_plus_1;
    uint32_t t = dec.threshold();
    // binary search: largest sym with row[sym] <= t
    int64_t lo = 0, hi = s - 1;
    while (lo < hi) {
      int64_t mid = (lo + hi + 1) >> 1;
      if (row[mid] <= t)
        lo = mid;
      else
        hi = mid - 1;
    }
    uint32_t c_lo = row[lo];
    uint32_t c_hi = (lo == s - 1) ? (1u << kTotalBits) : row[lo + 1];
    dec.consume(c_lo, c_hi - c_lo);
    symbols[i] = (int32_t)lo;
  }
  return 0;
}

// Single shared-CDF variant (all n symbols share one row) — used for the
// Bernoulli mask stream and per-channel factorized-prior streams.
int64_t rc_encode_shared(const uint16_t* cdf_row, int64_t s_plus_1, int64_t n,
                         const int32_t* symbols, uint8_t* out, int64_t cap) {
  Encoder enc;
  const int64_t s = s_plus_1 - 1;
  for (int64_t i = 0; i < n; i++) {
    int32_t sym = symbols[i];
    if (sym < 0 || sym >= s) return -1;
    uint32_t lo = cdf_row[sym];
    uint32_t hi = (sym == s - 1) ? (1u << kTotalBits) : cdf_row[sym + 1];
    if (hi <= lo) return -1;
    enc.encode(lo, hi - lo);
  }
  enc.flush();
  if ((int64_t)enc.out.size() > cap) return -1;
  std::memcpy(out, enc.out.data(), enc.out.size());
  return (int64_t)enc.out.size();
}

int64_t rc_decode_shared(const uint16_t* cdf_row, int64_t s_plus_1, int64_t n,
                         const uint8_t* data, int64_t data_len,
                         int32_t* symbols) {
  Decoder dec;
  dec.init(data, data_len);
  const int64_t s = s_plus_1 - 1;
  for (int64_t i = 0; i < n; i++) {
    uint32_t t = dec.threshold();
    int64_t lo = 0, hi = s - 1;
    while (lo < hi) {
      int64_t mid = (lo + hi + 1) >> 1;
      if (cdf_row[mid] <= t)
        lo = mid;
      else
        hi = mid - 1;
    }
    uint32_t c_lo = cdf_row[lo];
    uint32_t c_hi = (lo == s - 1) ? (1u << kTotalBits) : cdf_row[lo + 1];
    dec.consume(c_lo, c_hi - c_lo);
    symbols[i] = (int32_t)lo;
  }
  return 0;
}

}  // extern "C"
