"""Validator set: public keys, voting power, proposer rotation (copy of
`agnes_tpu.core.validators`).

Reference parity: src/validators.rs (56 LoC) — which does not compile as
shipped (SURVEY.md §2.6) — defines the *intent* implemented here:
a validator is a (public key, voting power) pair (validators.rs:5-8), a
validator's address is derived from its public key (validators.rs:15-17),
and a ValidatorSet is an address-sorted, deduplicated, mutable collection
(validators.rs:23-56) with a hash (validators.rs:11-13, TODO there).

Framework additions beyond the reference's intent:

* **Proposer rotation** — the "check if we're the proposer" stub at
  consensus_executor.rs:31-33 needs a deterministic proposer per
  (height, round).  `ProposerRotation` implements the classic Tendermint
  weighted round-robin: every step each validator's priority increases by
  its power, the max-priority validator proposes and pays the total power.
  Over time each validator proposes proportionally to its power.
  `proposer_table` precomputes a [heights, rounds] proposer-index table for
  upload to the device plane (numpy; the caller moves it).

* **Device export** — `device_arrays()` yields the validator tables of
  the north star (BASELINE.json) as numpy arrays for the device plane:
  [n, 32] uint8 Ed25519 public keys and [n] int64 voting powers,
  address-sorted so device index == host index.
"""

from __future__ import annotations

import bisect
import hashlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

PUBKEY_LEN = 32  # Ed25519 compressed public key


@dataclass(frozen=True, slots=True)
class Validator:
    """A public key and voting power (reference: validators.rs:4-8)."""

    public_key: bytes  # 32-byte Ed25519 public key
    voting_power: int

    def __post_init__(self):
        if len(self.public_key) != PUBKEY_LEN:
            raise ValueError(
                f"public_key must be {PUBKEY_LEN} bytes, got {len(self.public_key)}")
        if self.voting_power < 0:
            raise ValueError("voting_power must be non-negative")

    @property
    def address(self) -> bytes:
        """The validator's address: its public key (validators.rs:15-17
        returns the key directly; real Tendermint truncates a hash — we
        keep the reference's simpler rule)."""
        return self.public_key

    def hash(self) -> bytes:
        """Canonical digest of (key, power) — fills validators.rs:11-13's
        TODO with sha256 over a fixed-width encoding."""
        return hashlib.sha256(
            self.public_key + self.voting_power.to_bytes(8, "big")).digest()


class ValidatorSet:
    """Address-sorted, deduplicated validator collection
    (reference: validators.rs:22-56, intent)."""

    def __init__(self, validators: Iterable[Validator] = ()):
        # bulk path: dedup by address (latest wins), one sort — O(n log n)
        latest: Dict[bytes, Validator] = {v.address: v for v in validators}
        self._validators: List[Validator] = sorted(
            latest.values(), key=lambda v: v.address)
        self._by_address: Dict[bytes, int] = {}
        self._reindex()

    # -- internal ----------------------------------------------------------

    def _insert(self, val: Validator) -> None:
        """Insert keeping address order; an existing address is replaced
        (dedup, validators.rs:54)."""
        existing = self._by_address.get(val.address)
        if existing is not None:
            self._validators[existing] = val
            return
        i = bisect.bisect_left([v.address for v in self._validators], val.address)
        self._validators.insert(i, val)
        self._reindex()

    def _reindex(self) -> None:
        self._by_address = {v.address: i for i, v in enumerate(self._validators)}

    # -- queries -----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._validators)

    def __iter__(self):
        return iter(self._validators)

    def __getitem__(self, i: int) -> Validator:
        return self._validators[i]

    def index_of(self, address: bytes) -> Optional[int]:
        return self._by_address.get(address)

    @property
    def total_power(self) -> int:
        return sum(v.voting_power for v in self._validators)

    def hash(self) -> bytes:
        """Digest of the whole set (order-sensitive)."""
        h = hashlib.sha256()
        for v in self._validators:
            h.update(v.hash())
        return h.digest()

    # -- mutation (reference: validators.rs:33-46) -------------------------

    def add(self, val: Validator) -> None:
        self._insert(val)

    def update(self, val: Validator) -> None:
        """Update the voting power of an existing validator
        (validators.rs:38-41, empty TODO body there)."""
        i = self._by_address.get(val.address)
        if i is None:
            raise KeyError("unknown validator")
        self._validators[i] = val

    def remove(self, address: bytes) -> None:
        """Remove by address (validators.rs:43-46, empty TODO body)."""
        i = self._by_address.get(address)
        if i is None:
            raise KeyError("unknown validator")
        del self._validators[i]
        self._reindex()

    # -- device export -----------------------------------------------------

    def device_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(pubkeys [n, 32] uint8, powers [n] int64), address-sorted —
        the validator table the device plane uploads (BASELINE.json
        north star)."""
        n = len(self._validators)
        keys = np.zeros((n, PUBKEY_LEN), dtype=np.uint8)
        powers = np.zeros((n,), dtype=np.int64)
        for i, v in enumerate(self._validators):
            keys[i] = np.frombuffer(v.public_key, dtype=np.uint8)
            powers[i] = v.voting_power
        return keys, powers


@dataclass
class ProposerRotation:
    """Tendermint-style weighted round-robin proposer selection.

    Fills the "check if we're the proposer" stub (consensus_executor.rs:
    31-33).  Stateful: call `step()` once per (height, round) in order.
    Deterministic given the validator set, so every node computes the same
    proposer sequence.
    """

    vset: ValidatorSet
    # priorities are keyed by address so the rotation survives validator-set
    # changes: newcomers start at priority 0, removed validators drop out.
    priorities: Dict[bytes, int] = field(default_factory=dict)

    def step(self) -> int:
        """Advance one proposer slot; returns the proposer's index in the
        current (address-sorted) set."""
        if len(self.vset) == 0:
            raise ValueError("empty validator set")
        total = self.vset.total_power
        addrs = [v.address for v in self.vset]
        self.priorities = {a: self.priorities.get(a, 0) for a in addrs}
        for v in self.vset:
            self.priorities[v.address] += v.voting_power
        # max priority wins; ties break toward the lower address (index)
        proposer = max(range(len(addrs)),
                       key=lambda i: (self.priorities[addrs[i]], -i))
        self.priorities[addrs[proposer]] -= total
        return proposer


def proposer_table(vset: ValidatorSet, n_heights: int, n_rounds: int,
                   start_height: int = 0,
                   rotation: Optional[ProposerRotation] = None) -> np.ndarray:
    """Precompute proposer indices for a [n_heights, n_rounds] window —
    uploaded to the device so 10k batched instances can resolve
    NewRound vs NewRoundProposer without host round-trips.

    The rotation is a single global sequence walked in (height, round)
    order starting from genesis.  For sliding windows pass the `rotation`
    carried over from the previous call (it is advanced in place) instead
    of `start_height`, which replays start_height*n_rounds steps from
    genesis and is only meant for small offsets/tests."""
    rot = rotation if rotation is not None else ProposerRotation(vset)
    if rotation is None:
        for _ in range(start_height * n_rounds):
            rot.step()
    table = np.zeros((n_heights, n_rounds), dtype=np.int32)
    for h in range(n_heights):
        for r in range(n_rounds):
            table[h, r] = rot.step()
    return table
