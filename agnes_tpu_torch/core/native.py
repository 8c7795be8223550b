"""ctypes bindings over the port's native C++ core (twin of
`agnes_tpu.core.native`; sources in `core/native/`, built by
`core/native_build.py`).

The Python-facing API mirrors `core.state_machine` /
`core.round_votes` / `core.validators`, so tests drive both
implementations with the same inputs:

  native_apply(state, round, event) -> (state', Message | None)
      takes and returns the port's Python State/Event/Message types.
  NativeRoundVotes              mirrors core.round_votes.RoundVotes.
  NativeValidatorSet            mirrors core.validators.ValidatorSet
                                (address-sorted, deduped, hashable).
  NativeProposerRotation        mirrors core.validators.ProposerRotation.
  sha512                        host SHA-512 (C++).
  pubkey/sign/verify/verify_batch   host Ed25519 (C++, RFC 8032).

`crypto.host_sign` / `host_verify` are the port's host signer and
verifier through this module: the executor, the simulator, the
fixtures and the configs sign with it.  Host code only; the bulk verify
runs on the card (`crypto/ed25519.py::verify_batch`).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

from agnes_tpu_torch.core import state_machine as sm
from agnes_tpu_torch.core.native_build import lib
from agnes_tpu_torch.core.round_votes import Equivocation, Thresh, ThreshKind
from agnes_tpu_torch.types import Vote, VoteType

_NO = -1


class _AgState(ctypes.Structure):
    _fields_ = [("height", ctypes.c_int64), ("round", ctypes.c_int64),
                ("step", ctypes.c_int32), ("has_locked", ctypes.c_int32),
                ("has_valid", ctypes.c_int32),
                ("locked_round", ctypes.c_int64),
                ("locked_value", ctypes.c_int64),
                ("valid_round", ctypes.c_int64),
                ("valid_value", ctypes.c_int64)]


class _AgEvent(ctypes.Structure):
    _fields_ = [("tag", ctypes.c_int32), ("has_value", ctypes.c_int32),
                ("value", ctypes.c_int64), ("pol_round", ctypes.c_int64)]


class _AgMessage(ctypes.Structure):
    _fields_ = [("tag", ctypes.c_int32), ("round", ctypes.c_int64),
                ("p_value", ctypes.c_int64), ("p_pol_round", ctypes.c_int64),
                ("v_typ", ctypes.c_int32), ("v_has_value", ctypes.c_int32),
                ("v_value", ctypes.c_int64), ("t_step", ctypes.c_int32),
                ("d_round", ctypes.c_int64), ("d_value", ctypes.c_int64)]


def _configure(L):
    L.ag_apply.argtypes = [ctypes.POINTER(_AgState), ctypes.c_int64,
                           ctypes.POINTER(_AgEvent),
                           ctypes.POINTER(_AgState),
                           ctypes.POINTER(_AgMessage)]
    L.ag_tally_new.restype = ctypes.c_void_p
    L.ag_tally_new.argtypes = [ctypes.c_int64] * 3
    L.ag_tally_free.argtypes = [ctypes.c_void_p]
    L.ag_tally_add.restype = ctypes.c_int32
    L.ag_tally_add.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                               ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_int64)]
    L.ag_tally_skip_weight.restype = ctypes.c_int64
    L.ag_tally_skip_weight.argtypes = [ctypes.c_void_p]
    L.ag_tally_equiv_count.restype = ctypes.c_int64
    L.ag_tally_equiv_count.argtypes = [ctypes.c_void_p]
    L.ag_tally_equivocations.restype = ctypes.c_int64
    L.ag_tally_equivocations.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_int64),
                                         ctypes.c_int64]
    L.ag_valset_new.restype = ctypes.c_void_p
    L.ag_valset_new.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    L.ag_valset_free.argtypes = [ctypes.c_void_p]
    L.ag_valset_len.restype = ctypes.c_int64
    L.ag_valset_len.argtypes = [ctypes.c_void_p]
    L.ag_valset_total_power.restype = ctypes.c_int64
    L.ag_valset_total_power.argtypes = [ctypes.c_void_p]
    L.ag_valset_index_of.restype = ctypes.c_int64
    L.ag_valset_index_of.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    L.ag_rotation_new.restype = ctypes.c_void_p
    L.ag_rotation_new.argtypes = [ctypes.c_void_p]
    L.ag_rotation_free.argtypes = [ctypes.c_void_p]
    L.ag_rotation_step.restype = ctypes.c_int64
    L.ag_rotation_step.argtypes = [ctypes.c_void_p]
    L.ag_valset_hash.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    L.ag_valset_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    L.ag_valset_update.restype = ctypes.c_int32
    L.ag_valset_update.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int64]
    L.ag_valset_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int64]
    L.ag_valset_remove.restype = ctypes.c_int32
    L.ag_valset_remove.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    L.ag_sha512.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
    L.ag_ed25519_pubkey.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    L.ag_ed25519_sign.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int64, ctypes.c_char_p]
    L.ag_ed25519_verify.restype = ctypes.c_int32
    L.ag_ed25519_verify.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_int64, ctypes.c_char_p]
    L.ag_ed25519_verify_batch.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                          ctypes.c_char_p, ctypes.c_int64,
                                          ctypes.c_int64, ctypes.c_char_p]
    return L


_L = None


def _lib():
    global _L
    if _L is None:
        _L = _configure(lib())
    return _L


# --- state machine ----------------------------------------------------------

def _to_c_state(s: sm.State) -> _AgState:
    return _AgState(
        height=s.height, round=s.round, step=int(s.step),
        has_locked=int(s.locked is not None),
        has_valid=int(s.valid is not None),
        locked_round=s.locked.round if s.locked else _NO,
        locked_value=s.locked.value if s.locked else _NO,
        valid_round=s.valid.round if s.valid else _NO,
        valid_value=s.valid.value if s.valid else _NO)


def _from_c_state(c: _AgState) -> sm.State:
    return sm.State(
        height=c.height, round=c.round, step=sm.Step(c.step),
        locked=sm.RoundValue(c.locked_round, c.locked_value)
        if c.has_locked else None,
        valid=sm.RoundValue(c.valid_round, c.valid_value)
        if c.has_valid else None)


def _from_c_message(m: _AgMessage) -> Optional[sm.Message]:
    tag = sm.MsgTag(m.tag)
    if tag == sm.MsgTag.NONE:
        return None
    if tag == sm.MsgTag.NEW_ROUND:
        return sm.Message.new_round(m.round)
    if tag == sm.MsgTag.PROPOSAL:
        return sm.Message.proposal_msg(m.round, m.p_value, m.p_pol_round)
    if tag == sm.MsgTag.VOTE:
        value = m.v_value if m.v_has_value else None
        ctor = (sm.Message.prevote if m.v_typ == int(VoteType.PREVOTE)
                else sm.Message.precommit)
        return ctor(m.round, value)
    if tag == sm.MsgTag.TIMEOUT:
        return sm.Message.timeout_msg(m.round, sm.TimeoutStep(m.t_step))
    return sm.Message.decision_msg(m.d_round, m.d_value)


def native_apply(s: sm.State, round: int, event: sm.Event
                 ) -> Tuple[sm.State, Optional[sm.Message]]:
    """C++ `apply` with the Python core's types (differential surface)."""
    L = _lib()
    c_ev = _AgEvent(tag=int(event.tag),
                    has_value=int(event.value is not None),
                    value=event.value if event.value is not None else _NO,
                    pol_round=event.pol_round)
    c_in = _to_c_state(s)
    c_out, c_msg = _AgState(), _AgMessage()
    L.ag_apply(ctypes.byref(c_in), round, ctypes.byref(c_ev),
               ctypes.byref(c_out), ctypes.byref(c_msg))
    return _from_c_state(c_out), _from_c_message(c_msg)


# --- tally ------------------------------------------------------------------

class NativeRoundVotes:
    """C++ RoundVotes mirroring core.round_votes.RoundVotes."""

    def __init__(self, height: int, round: int, total: int):
        L = _lib()
        self._h = L.ag_tally_new(height, round, total)
        self._free = L.ag_tally_free   # bound now: module globals are
        self._height, self._round = height, round  # gone at shutdown

    def __del__(self):
        if getattr(self, "_h", None):
            self._free(self._h)
            self._h = None

    def add_vote(self, vote: Vote, weight: int) -> Thresh:
        tv = ctypes.c_int64(0)
        kind = _lib().ag_tally_add(
            self._h, int(vote.typ),
            vote.validator if vote.validator is not None else _NO,
            vote.value if vote.value is not None else _NO,
            weight, ctypes.byref(tv))
        kind = ThreshKind(kind)
        value = tv.value if kind == ThreshKind.VALUE else None
        return Thresh(kind, value)

    def skip_weight(self) -> int:
        return _lib().ag_tally_skip_weight(self._h)

    @property
    def equivocations(self) -> List[Equivocation]:
        cap = _lib().ag_tally_equiv_count(self._h)
        if cap == 0:
            return []
        buf = (ctypes.c_int64 * (5 * cap))()
        n = _lib().ag_tally_equivocations(self._h, buf, cap)
        out = []
        for i in range(n):
            r, typ, val, first, second = buf[5 * i:5 * i + 5]
            out.append(Equivocation(
                self._height, r, VoteType(typ), val,
                None if first == _NO else first,
                None if second == _NO else second))
        return out


# --- validator set ----------------------------------------------------------

class NativeValidatorSet:
    """C++ ValidatorSet: address-sorted, deduped, hashable (validators.rs
    §2.6 intent); mirrors core.validators.ValidatorSet."""

    def __init__(self, validators: Sequence[Tuple[bytes, int]]):
        packed = b"".join(
            pk + int(power).to_bytes(8, "little", signed=True)
            for pk, power in validators)
        L = _lib()
        self._h = L.ag_valset_new(packed, len(validators))
        self._free = L.ag_valset_free  # bound now, survives shutdown

    def __del__(self):
        if getattr(self, "_h", None):
            self._free(self._h)
            self._h = None

    def __len__(self) -> int:
        return _lib().ag_valset_len(self._h)

    @property
    def total_power(self) -> int:
        return _lib().ag_valset_total_power(self._h)

    def index_of(self, pubkey: bytes) -> int:
        return _lib().ag_valset_index_of(self._h, pubkey)

    def hash(self) -> bytes:
        out = ctypes.create_string_buffer(32)
        _lib().ag_valset_hash(self._h, out)
        return out.raw

    def validators(self) -> List[Tuple[bytes, int]]:
        n = len(self)
        out = ctypes.create_string_buffer(40 * n)
        _lib().ag_valset_get(self._h, out)
        raw = out.raw
        return [(raw[40 * i:40 * i + 32],
                 int.from_bytes(raw[40 * i + 32:40 * i + 40], "little",
                                signed=True))
                for i in range(n)]

    def add(self, pubkey: bytes, power: int) -> None:
        _lib().ag_valset_add(self._h, pubkey, power)

    def update(self, pubkey: bytes, power: int) -> bool:
        return bool(_lib().ag_valset_update(self._h, pubkey, power))

    def remove(self, pubkey: bytes) -> bool:
        return bool(_lib().ag_valset_remove(self._h, pubkey))


class NativeProposerRotation:
    """C++ ProposerRotation: the stateful priority algorithm of
    core.validators.ProposerRotation, so the host-native, host-Python
    and device proposer tables name the same proposer for every
    (height, round) slot.  The C++ side holds a non-owning pointer to
    the validator set, so this object keeps the set alive."""

    def __init__(self, vset: NativeValidatorSet):
        L = _lib()
        self._vset = vset                       # lifetime anchor
        self._h = L.ag_rotation_new(vset._h)
        self._free = L.ag_rotation_free

    def __del__(self):
        if getattr(self, "_h", None):
            self._free(self._h)
            self._h = None

    def step(self) -> int:
        return _lib().ag_rotation_step(self._h)


# --- crypto -----------------------------------------------------------------

def sha512(data: bytes) -> bytes:
    out = ctypes.create_string_buffer(64)
    _lib().ag_sha512(data, len(data), out)
    return out.raw


def pubkey(seed: bytes) -> bytes:
    if len(seed) != 32:
        raise ValueError("ed25519 seed must be 32 bytes")
    out = ctypes.create_string_buffer(32)
    _lib().ag_ed25519_pubkey(seed, out)
    return out.raw


def sign(seed: bytes, msg: bytes) -> bytes:
    if len(seed) != 32:
        raise ValueError("ed25519 seed must be 32 bytes")
    out = ctypes.create_string_buffer(64)
    _lib().ag_ed25519_sign(seed, msg, len(msg), out)
    return out.raw


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    # The C ABI reads pk[0..31] and sig[0..63] unconditionally; length
    # must be enforced here or attacker-length inputs become OOB reads.
    if len(pk) != 32 or len(sig) != 64:
        return False
    return bool(_lib().ag_ed25519_verify(pk, msg, len(msg), sig))


def verify_batch(pks: Sequence[bytes], msgs: Sequence[bytes],
                 sigs: Sequence[bytes]) -> List[bool]:
    """Host batch verify of fixed-length messages (C++, one lane after
    another): a host oracle for the batched CUDA verify."""
    if not pks:
        return []
    msg_len = len(msgs[0])
    assert all(len(m) == msg_len for m in msgs)
    ok_idx = [i for i in range(len(pks))
              if len(pks[i]) == 32 and len(sigs[i]) == 64]
    if len(ok_idx) != len(pks):
        # keep the packed C call aligned: verify well-formed entries
        # only, report False for the rest
        sub = verify_batch([pks[i] for i in ok_idx],
                           [msgs[i] for i in ok_idx],
                           [sigs[i] for i in ok_idx])
        res = [False] * len(pks)
        for i, good in zip(ok_idx, sub):
            res[i] = good
        return res
    out = ctypes.create_string_buffer(len(pks))
    _lib().ag_ed25519_verify_batch(
        b"".join(pks), b"".join(sigs), b"".join(msgs),
        msg_len, len(pks), out)
    return [b != 0 for b in out.raw]
