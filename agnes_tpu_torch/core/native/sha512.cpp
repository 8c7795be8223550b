// SHA-512 implementation (FIPS 180-4).  K/IV constants come from the
// build-time generated sha512_k.inc (see sha512.hpp).

#include "sha512.hpp"

#include <cstring>

namespace agnes {

namespace {
#include "sha512_k.inc"   // defines kK[80] and kH0[8]

inline uint64_t rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }
inline uint64_t big_sigma0(uint64_t a) {
  return rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
}
inline uint64_t big_sigma1(uint64_t e) {
  return rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
}
inline uint64_t sm_sigma0(uint64_t w) {
  return rotr(w, 1) ^ rotr(w, 8) ^ (w >> 7);
}
inline uint64_t sm_sigma1(uint64_t w) {
  return rotr(w, 19) ^ rotr(w, 61) ^ (w >> 6);
}

void compress(uint64_t h[8], const uint8_t block[128]) {
  uint64_t w[80];
  for (int t = 0; t < 16; ++t) {
    w[t] = 0;
    for (int b = 0; b < 8; ++b)
      w[t] = (w[t] << 8) | block[8 * t + b];
  }
  for (int t = 16; t < 80; ++t)
    w[t] = sm_sigma1(w[t - 2]) + w[t - 7] + sm_sigma0(w[t - 15]) + w[t - 16];

  uint64_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint64_t e = h[4], f = h[5], g = h[6], hh = h[7];
  for (int t = 0; t < 80; ++t) {
    uint64_t t1 = hh + big_sigma1(e) + ((e & f) ^ (~e & g)) + kK[t] + w[t];
    uint64_t t2 = big_sigma0(a) + ((a & b) ^ (a & c) ^ (b & c));
    hh = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

// --- SHA-256 (FIPS 180-4 §6.2) ---------------------------------------------

inline uint32_t rotr32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

void compress256(uint32_t h[8], const uint8_t block[64]) {
  uint32_t w[64];
  for (int t = 0; t < 16; ++t)
    w[t] = (uint32_t(block[4 * t]) << 24) |
           (uint32_t(block[4 * t + 1]) << 16) |
           (uint32_t(block[4 * t + 2]) << 8) | uint32_t(block[4 * t + 3]);
  for (int t = 16; t < 64; ++t) {
    uint32_t s0 = rotr32(w[t - 15], 7) ^ rotr32(w[t - 15], 18) ^
                  (w[t - 15] >> 3);
    uint32_t s1 = rotr32(w[t - 2], 17) ^ rotr32(w[t - 2], 19) ^
                  (w[t - 2] >> 10);
    w[t] = w[t - 16] + s0 + w[t - 7] + s1;
  }
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
  for (int t = 0; t < 64; ++t) {
    uint32_t t1 = hh + (rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25)) +
                  ((e & f) ^ (~e & g)) + kK256[t] + w[t];
    uint32_t t2 = (rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22)) +
                  ((a & b) ^ (a & c) ^ (b & c));
    hh = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

}  // namespace

void sha256(const uint8_t* data, size_t n, uint8_t out[32]) {
  uint32_t h[8];
  std::memcpy(h, kH256, sizeof(h));
  size_t off = 0;
  for (; off + 64 <= n; off += 64) compress256(h, data + off);
  // final: remainder + 0x80 pad + zero fill + 64-bit bit length —
  // at most two trailing blocks (rem <= 63, so rem + 1 + 8 <= 128)
  uint8_t buf[128];
  size_t rem = n - off;
  if (rem) std::memcpy(buf, data + off, rem);
  buf[rem++] = 0x80;
  size_t blocks = (rem + 8 <= 64) ? 1 : 2;
  std::memset(buf + rem, 0, blocks * 64 - 8 - rem);
  uint64_t bits = uint64_t(n) << 3;
  for (int i = 0; i < 8; ++i)
    buf[blocks * 64 - 8 + i] = (bits >> (56 - 8 * i)) & 0xFF;
  compress256(h, buf);
  if (blocks == 2) compress256(h, buf + 64);
  for (int i = 0; i < 8; ++i)
    for (int b = 0; b < 4; ++b)
      out[4 * i + b] = (h[i] >> (24 - 8 * b)) & 0xFF;
}

Sha512::Sha512() { std::memcpy(h, kH0, sizeof(h)); }

void Sha512::update(const uint8_t* data, size_t n) {
  size_t fill = static_cast<size_t>(len % 128);
  len += n;
  if (fill) {
    size_t take = 128 - fill;
    if (take > n) take = n;
    std::memcpy(buf + fill, data, take);
    data += take; n -= take; fill += take;
    if (fill == 128) compress(h, buf);
    else return;
  }
  while (n >= 128) {
    compress(h, data);
    data += 128; n -= 128;
  }
  if (n) std::memcpy(buf, data, n);
}

void Sha512::final(uint8_t out[64]) {
  uint64_t bits_hi = len >> 61, bits_lo = len << 3;
  size_t fill = static_cast<size_t>(len % 128);
  buf[fill++] = 0x80;
  if (fill > 112) {
    std::memset(buf + fill, 0, 128 - fill);
    compress(h, buf);
    fill = 0;
  }
  std::memset(buf + fill, 0, 112 - fill);
  for (int i = 0; i < 8; ++i) buf[112 + i] = (bits_hi >> (56 - 8 * i)) & 0xFF;
  for (int i = 0; i < 8; ++i) buf[120 + i] = (bits_lo >> (56 - 8 * i)) & 0xFF;
  compress(h, buf);
  for (int i = 0; i < 8; ++i)
    for (int b = 0; b < 8; ++b)
      out[8 * i + b] = (h[i] >> (56 - 8 * b)) & 0xFF;
}

void sha512(const uint8_t* data, size_t n, uint8_t out[64]) {
  Sha512 s;
  s.update(data, n);
  s.final(out);
}

}  // namespace agnes
