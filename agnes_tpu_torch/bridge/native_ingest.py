"""The 96-byte wire record codec (the wire half of the twin's
`agnes_tpu.bridge.native_ingest`).

A wire vote is one packed record: instance (u32), validator (u32),
height (i64), round (i32), class (u8), a non-nil flag (u8), two pad
bytes, value (i64) and the 64-byte Ed25519 signature, little-endian.
`pack_wire_votes` builds records from columns and `unpack_wire_votes`
is its exact inverse; the serve plane's admission queue parses with it.
Pure numpy.  The twin's C++ ingestion loop (`NativeIngestLoop`) waits
for the native admission front end (ROADMAP §1 item 4).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

REC_SIZE = 96


def pack_wire_votes(instance, validator, height, round_, typ, value,
                    signatures: Optional[np.ndarray] = None) -> bytes:
    """Column arrays -> packed 96-byte wire records (vectorized).
    value < 0 encodes nil."""
    n = len(np.asarray(instance))
    rec = np.zeros((n, REC_SIZE), np.uint8)
    rec[:, 0:4] = np.asarray(instance, np.uint32)[:, None].view(
        np.uint8).reshape(n, 4)
    rec[:, 4:8] = np.asarray(validator, np.uint32)[:, None].view(
        np.uint8).reshape(n, 4)
    rec[:, 8:16] = np.asarray(height, np.int64)[:, None].view(
        np.uint8).reshape(n, 8)
    rec[:, 16:20] = np.asarray(round_, np.int32)[:, None].view(
        np.uint8).reshape(n, 4)
    rec[:, 20] = np.asarray(typ, np.uint8)
    val = np.asarray(value, np.int64)
    rec[:, 21] = (val >= 0).astype(np.uint8)
    rec[:, 24:32] = np.maximum(val, 0)[:, None].view(
        np.uint8).reshape(n, 8)
    if signatures is not None:
        rec[:, 32:96] = np.asarray(signatures, np.uint8).reshape(n, 64)
    return rec.tobytes()


def unpack_wire_votes(wire) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
    """Packed 96-byte wire records -> column arrays (vectorized), the
    exact inverse of `pack_wire_votes`: (instance, validator, height,
    round, typ, value, signatures[N, 64]); value is -1 for nil.  A
    trailing partial record is dropped (the caller counts it via
    `len(wire) % REC_SIZE`)."""
    buf = np.frombuffer(wire, np.uint8) if isinstance(wire, (bytes,
                                                             bytearray,
                                                             memoryview)) \
        else np.asarray(wire, np.uint8).ravel()
    n = len(buf) // REC_SIZE
    rec = buf[:n * REC_SIZE].reshape(n, REC_SIZE)

    def field(lo, hi, dt):
        return np.ascontiguousarray(rec[:, lo:hi]).view(dt)[:, 0]

    inst = field(0, 4, np.uint32).astype(np.int64)
    val = field(4, 8, np.uint32).astype(np.int64)
    height = field(8, 16, np.int64).copy()
    round_ = field(16, 20, np.int32).astype(np.int64)
    typ = rec[:, 20].astype(np.int64)
    nonnil = rec[:, 21] != 0
    value = np.where(nonnil, field(24, 32, np.int64), -1)
    sigs = np.ascontiguousarray(rec[:, 32:96])
    return inst, val, height, round_, typ, value, sigs
