// SHA-512 (FIPS 180-4) for the native core: validator-set hashing and
// the Ed25519 sign/verify challenge hash.  Written from the spec; the
// round constants are generated at build time by native_build.py from
// their definition (frac parts of cube roots of the first 80 primes)
// into sha512_k.inc, from the integer roots crypto/sha512.py uses, so
// the torch and C++ implementations share one constant source.
#pragma once

#include <cstddef>
#include <cstdint>

namespace agnes {

struct Sha512 {
  uint64_t h[8];
  uint8_t buf[128];
  uint64_t len = 0;   // total bytes absorbed

  Sha512();
  void update(const uint8_t* data, size_t n);
  void final(uint8_t out[64]);
};

void sha512(const uint8_t* data, size_t n, uint8_t out[64]);

// SHA-256 (FIPS 180-4 §6.2), one-shot: the serve plane's dedup-cache
// digest (serve/cache.VerifiedCache keys on the SHA-256 of the
// 96-byte wire record).  Same generated-constant source as SHA-512:
// kK256/kH256 land in sha512_k.inc from their FIPS definitions (frac
// parts of cube/square roots of the first primes), asserted against
// the published first/last words at generation time.
void sha256(const uint8_t* data, size_t n, uint8_t out[32]);

}  // namespace agnes
