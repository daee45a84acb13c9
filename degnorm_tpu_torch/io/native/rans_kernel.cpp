// rANS 4x8 decode fast path (CRAM 3.0 block compression method 4).
//
// This package's copy of degnorm_tpu/io/native/rans_kernel.cpp.  Mirrors
// io/rans.py's pure-Python decoder exactly (same table parse, state
// machine, and interleaving); that file holds the format documentation.
// The Python encoder/decoder pair remains the semantic source of truth;
// this kernel is byte-for-byte validated against it in
// tests/test_torch_cram.py.  The Python decoder runs at about 1 MB/s, this
// one at hundreds of MB/s, which is what makes real-file CRAM ETL
// practical.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kTfShift = 12;
constexpr uint32_t kTotFreq = 1u << kTfShift;
constexpr uint32_t kRansLow = 1u << 23;

// Order-0-style frequency table with symbol run-length elision.
// Returns the new offset, or -1 on truncation/corruption.
int64_t read_freqs(const uint8_t* buf, int64_t n, int64_t off,
                   uint32_t* F /* 256 */) {
  std::memset(F, 0, 256 * sizeof(uint32_t));
  if (off >= n) return -1;
  int rle = 0;
  int j = buf[off++];
  int last = -2;
  for (;;) {
    if (rle) {
      rle--;
    } else if (j == last + 1) {
      if (off >= n) return -1;
      rle = buf[off++];
    }
    if (off >= n) return -1;
    uint32_t f = buf[off++];
    if (f >= 128) {
      if (off >= n) return -1;
      f = ((f & 0x7F) << 8) | buf[off++];
    }
    F[j] = f;
    last = j;
    if (rle) {
      j++;
      if (j > 255) return -1;
    } else {
      if (off >= n) return -1;
      j = buf[off++];
      if (j == 0) break;
    }
  }
  return off;
}

struct Ctx {
  uint32_t freq[256];
  uint32_t cum[257];
  uint8_t sym[kTotFreq];
};

// cum + symbol-lookup tables; false if frequencies exceed TOTFREQ.
bool build_ctx(const uint32_t* F, Ctx* c) {
  std::memcpy(c->freq, F, 256 * sizeof(uint32_t));
  c->cum[0] = 0;
  for (int s = 0; s < 256; s++) c->cum[s + 1] = c->cum[s] + F[s];
  if (c->cum[256] > kTotFreq) return false;
  for (int s = 0; s < 256; s++)
    for (uint32_t m = c->cum[s]; m < c->cum[s + 1]; m++) c->sym[m] = s;
  // mask values past cum[256] (never produced by a conforming encoder)
  for (uint32_t m = c->cum[256]; m < kTotFreq; m++) c->sym[m] = 0;
  return true;
}

inline bool renorm(uint32_t& x, const uint8_t* buf, int64_t n,
                   int64_t& ptr) {
  while (x < kRansLow) {
    if (ptr >= n) return false;
    x = (x << 8) | buf[ptr++];
  }
  return true;
}

int64_t decode_o0(const uint8_t* buf, int64_t n, uint8_t* out,
                  int64_t out_sz) {
  uint32_t F[256];
  int64_t off = read_freqs(buf, n, 0, F);
  if (off < 0) return -1;
  std::vector<Ctx> ctx(1);
  if (!build_ctx(F, &ctx[0])) return -1;
  const Ctx& c = ctx[0];
  if (off + 16 > n) return -1;
  uint32_t R[4];
  for (int j = 0; j < 4; j++) {
    std::memcpy(&R[j], buf + off, 4);   // little-endian host assumed (x86)
    off += 4;
  }
  int64_t ptr = off;
  for (int64_t i = 0; i < out_sz; i++) {
    uint32_t& x = R[i & 3];
    uint32_t m = x & (kTotFreq - 1);
    uint8_t s = c.sym[m];
    if (!c.freq[s]) return -1;
    out[i] = s;
    x = c.freq[s] * (x >> kTfShift) + m - c.cum[s];
    if (!renorm(x, buf, n, ptr)) return -1;
  }
  return out_sz;
}

int64_t decode_o1(const uint8_t* buf, int64_t n, uint8_t* out,
                  int64_t out_sz) {
  // outer RLE over contexts, each with an order-0-style row
  std::vector<Ctx> ctx(256);
  std::vector<bool> have(256, false);
  if (n < 1) return -1;
  int64_t off = 0;
  int rle = 0;
  int i = buf[off++];
  int last = -2;
  for (;;) {
    if (rle) {
      rle--;
    } else if (i == last + 1) {
      if (off >= n) return -1;
      rle = buf[off++];
    }
    uint32_t F[256];
    off = read_freqs(buf, n, off, F);
    if (off < 0) return -1;
    if (!build_ctx(F, &ctx[i])) return -1;
    have[i] = true;
    last = i;
    if (rle) {
      i++;
      if (i > 255) return -1;
    } else {
      if (off >= n) return -1;
      i = buf[off++];
      if (i == 0) break;
    }
  }
  if (off + 16 > n) return -1;
  uint32_t R[4];
  for (int j = 0; j < 4; j++) {
    std::memcpy(&R[j], buf + off, 4);
    off += 4;
  }
  int64_t ptr = off;
  int64_t isz4 = out_sz >> 2;
  uint8_t lastsym[4] = {0, 0, 0, 0};

  auto step = [&](int j, int64_t pos) -> bool {
    uint32_t& x = R[j];
    const int l = lastsym[j];
    if (!have[l]) return false;
    const Ctx& c = ctx[l];
    uint32_t m = x & (kTotFreq - 1);
    uint8_t s = c.sym[m];
    if (!c.freq[s]) return false;
    out[pos] = s;
    x = c.freq[s] * (x >> kTfShift) + m - c.cum[s];
    lastsym[j] = s;
    return renorm(x, buf, n, ptr);
  };

  for (int64_t k = 0; k < isz4; k++)
    for (int j = 0; j < 4; j++)
      if (!step(j, (int64_t)j * isz4 + k)) return -1;
  for (int64_t pos = 4 * isz4; pos < out_sz; pos++)   // tail: state 3
    if (!step(3, pos)) return -1;
  return out_sz;
}

}  // namespace

extern "C" {

// Scan an entire external block of ITF8 varints (CRAM 3.0 §2.3) into
// int32s.  Returns the value count, -1 if out_cap is exceeded, or -2 if
// the block does not end exactly on a value boundary (the vectorized
// CRAM decoder then hands the slice to the per-record decoder).
int64_t dn_itf8_scan(const uint8_t* buf, int64_t n, int32_t* out,
                     int64_t out_cap) {
  int64_t off = 0, cnt = 0;
  while (off < n) {
    if (cnt >= out_cap) return -1;
    uint8_t b0 = buf[off];
    int need;
    uint32_t v;
    if (b0 < 0x80) {
      need = 1;
      v = b0;
    } else if (b0 < 0xC0) {
      need = 2;
      if (off + need > n) return -2;
      v = ((uint32_t)(b0 & 0x3F) << 8) | buf[off + 1];
    } else if (b0 < 0xE0) {
      need = 3;
      if (off + need > n) return -2;
      v = ((uint32_t)(b0 & 0x1F) << 16) | ((uint32_t)buf[off + 1] << 8) |
          buf[off + 2];
    } else if (b0 < 0xF0) {
      need = 4;
      if (off + need > n) return -2;
      v = ((uint32_t)(b0 & 0x0F) << 24) | ((uint32_t)buf[off + 1] << 16) |
          ((uint32_t)buf[off + 2] << 8) | buf[off + 3];
    } else {
      need = 5;
      if (off + need > n) return -2;
      v = ((uint32_t)(b0 & 0x0F) << 28) | ((uint32_t)buf[off + 1] << 20) |
          ((uint32_t)buf[off + 2] << 12) | ((uint32_t)buf[off + 3] << 4) |
          (buf[off + 4] & 0x0F);
    }
    out[cnt++] = (int32_t)v;
    off += need;
  }
  return cnt;
}

// Full CRAM rANS payload (9-byte header + table + stream) -> out.
// Returns bytes written, or -1 on any truncation/corruption/cap error.
int64_t dn_rans_uncompress(const uint8_t* payload, int64_t plen,
                           uint8_t* out, int64_t out_cap) {
  if (plen < 9) return -1;
  int order = payload[0];
  uint32_t comp_sz, out_sz;
  std::memcpy(&comp_sz, payload + 1, 4);
  std::memcpy(&out_sz, payload + 5, 4);
  if ((int64_t)out_sz > out_cap) return -1;
  if (9 + (int64_t)comp_sz > plen) return -1;
  if (out_sz == 0) return 0;
  const uint8_t* body = payload + 9;
  if (order == 0) return decode_o0(body, comp_sz, out, out_sz);
  if (order == 1) return decode_o1(body, comp_sz, out, out_sz);
  return -1;
}

}  // extern "C"
