"""Signed-traffic fixtures (twin of `agnes_tpu.harness.fixtures`) and
the adversarial verify grid the tests and `chip_smoke.py` share.

Keys and signatures come from the port's host signer (`core.native`
through `crypto.host_sign`, the C++ core built with g++ at first use);
`sign_class` signs one message per validator, so every instance of a
class reuses its validator's signature (the JAX twin's layout).  The
adversarial grid's crafted lanes (`torsioned_sig`, out-of-range S and
y) need the pure-Python oracle's internals (`crypto/ed25519_ref.py`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from agnes_tpu_torch.bridge.ingest import vote_messages_np
from agnes_tpu_torch.core import native
from agnes_tpu_torch.crypto import ed25519_ref as ref
from agnes_tpu_torch.crypto import host_sign


def deterministic_seeds(n_validators: int) -> List[bytes]:
    """The fixture keyspace: 32-byte seeds derived from the validator
    index (little-endian in the first 4 bytes)."""
    return [v.to_bytes(4, "little") + bytes(28)
            for v in range(n_validators)]


def validator_pubkeys(seeds: List[bytes]) -> np.ndarray:
    """[V, 32] uint8 table for the given seeds."""
    return np.stack([np.frombuffer(native.pubkey(s), np.uint8)
                     for s in seeds])


def sign_class(seeds: List[bytes], height: int, typ: int, value: int,
               round_: int = 0,
               forge_validator: Optional[int] = None) -> np.ndarray:
    """[V, 64] uint8 signatures, one per validator, over the canonical
    vote message for (height, round, typ, value).  `forge_validator`
    signs with its neighbor's key instead (a forged lane that fails
    verification against the validator's own pubkey)."""
    V = len(seeds)
    msgs = vote_messages_np(np.full(V, height, np.int64),
                            np.full(V, round_, np.int64),
                            np.full(V, typ, np.int64),
                            np.full(V, value, np.int64))
    sigs = np.stack([np.frombuffer(host_sign(seeds[v], msgs[v].tobytes()),
                                   np.uint8) for v in range(V)])
    if forge_validator is not None:
        wrong = (forge_validator + 1) % V
        sigs[forge_validator] = np.frombuffer(
            host_sign(seeds[wrong], msgs[forge_validator].tobytes()),
            np.uint8)
    return sigs


def full_mesh_cols(n_instances: int, n_validators: int, seeds: List[bytes],
                   height: int, typ: int, value: int, round_: int = 0,
                   forge_validator: Optional[int] = None,
                   sigs: Optional[np.ndarray] = None) -> Tuple:
    """add_arrays column set for "every validator votes `value` in every
    instance", with real signatures: (instance, validator, height, round,
    typ, value, signatures[N, 64]).  `sigs` reuses a `sign_class` result
    signed for exactly these arguments."""
    I, V = n_instances, n_validators
    inst = np.repeat(np.arange(I), V)
    val = np.tile(np.arange(V), I)
    n = I * V
    if sigs is None:
        sigs = sign_class(seeds, height, typ, value, round_=round_,
                          forge_validator=forge_validator)
    return (inst, val, np.full(n, height, np.int64),
            np.full(n, round_, np.int64), np.full(n, typ, np.int64),
            np.full(n, value, np.int64), sigs[val])


def torsioned_sig(seed: bytes, msg: bytes) -> Tuple[bytes, bytes, bytes]:
    """(pub, msg, sig) whose verification defect is a pure small-order
    torsion point: fails the exact equation, satisfies the x8 one (the
    case that separates cofactored from cofactorless verifiers)."""
    h = ref._sha512(seed)
    a = ref._clamp(h)
    pub = ref._compress(ref._mul(a, ref.BASE))
    r = ref._sha512_int(h[32:] + b"torsion" + msg) % ref.L
    tau = ref._decompress(bytes(32))       # y = 0: order-4 point
    rp = ref._add(ref._mul(r, ref.BASE), tau)
    rb = ref._compress(rp)
    k = ref._sha512_int(rb + pub + msg) % ref.L
    s = (r + k * a) % ref.L
    return pub, msg, rb + s.to_bytes(32, "little")


def adversarial_grid() -> Tuple[List[bytes], List[bytes], List[bytes]]:
    """(pubs, msgs, sigs): the good + adversarial lanes of the JAX
    package's verify tests (`tests/test_pallas_verify.py::_cases`),
    rebuilt from the port's own signer.  Lanes 0-3 honest; 4-11 corrupted
    R, corrupted S, wrong message, wrong key, S + L, y >= p, off-curve
    key, flipped R sign; 12-15 random bytes; 16 x = 0 with sign 1;
    17 torsion defect (accepted under the cofactored policy)."""
    rng = np.random.RandomState(42)
    pubs, msgs, sigs = [], [], []

    def add(pub, msg, sig):
        pubs.append(pub)
        msgs.append(msg)
        sigs.append(sig)

    keys = [ref.keypair(bytes([i + 1]) * 32) for i in range(4)]
    base_msgs = [bytes([i]) * 45 for i in range(4)]
    base_sigs = [ref.sign(sk, m) for (sk, _), m in zip(keys, base_msgs)]
    for (sk, pk), m, s in zip(keys, base_msgs, base_sigs):
        add(pk, m, s)
    s = bytearray(base_sigs[0])
    s[3] ^= 1
    add(keys[0][1], base_msgs[0], bytes(s))
    s = bytearray(base_sigs[1])
    s[40] ^= 1
    add(keys[1][1], base_msgs[1], bytes(s))
    add(keys[2][1], b"\x77" * 45, base_sigs[2])
    add(keys[3][1], base_msgs[0], base_sigs[0])
    s_int = int.from_bytes(base_sigs[0][32:], "little")
    add(keys[0][1], base_msgs[0],
        base_sigs[0][:32] + (s_int + ref.L).to_bytes(32, "little"))
    add(keys[0][1], base_msgs[0],
        (ref.P + 1).to_bytes(32, "little") + base_sigs[0][32:])
    add((2).to_bytes(32, "little"), base_msgs[0], base_sigs[0])
    r = bytearray(base_sigs[2])
    r[31] ^= 0x80
    add(keys[2][1], base_msgs[2], bytes(r))
    for _ in range(4):
        add(rng.bytes(32), rng.bytes(45), rng.bytes(64))
    enc_id = bytearray((1).to_bytes(32, "little"))
    enc_id[31] |= 0x80
    add(bytes(enc_id), base_msgs[0], base_sigs[0])
    add(*torsioned_sig(bytes([9]) * 32, base_msgs[0]))
    msgs = [m[:45].ljust(45, b"\0") for m in msgs]
    return pubs, msgs, sigs
