// Ed25519 (RFC 8032) for the native host core: signing for the
// executor's own votes/proposals (the reference stubs "sign the vote",
// consensus_executor.rs:35-41) and verification as the host fallback /
// oracle for the batched CUDA verifier.  Written from the RFC: radix-2^51
// field arithmetic on unsigned __int128 products, extended-coordinate
// points, variable-time scalar multiplication (verification handles
// public data only; signing uses only the caller-supplied seed and is
// not hardened against timing side channels — fixture/driver use).
#pragma once

#include <cstdint>

namespace agnes {

// public_key[32] out of seed[32]
void ed25519_pubkey(const uint8_t seed[32], uint8_t out_pk[32]);

// signature[64] = R || S over msg
void ed25519_sign(const uint8_t seed[32], const uint8_t* msg, uint64_t n,
                  uint8_t out_sig[64]);

// full RFC 8032 §5.1.7 verification (canonical A/R, S < L, group eq)
bool ed25519_verify(const uint8_t pk[32], const uint8_t* msg, uint64_t n,
                    const uint8_t sig[64]);

}  // namespace agnes
