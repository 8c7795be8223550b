"""Value interning and per-instance slot mapping.

Device values are 31-bit ids (types.py design decision: the
reference's `Value {}` placeholder becomes a fixed-width lane);
payloads stay on host.  The tally kernels index value buckets by an
instance-local dense *slot* in [0, n_slots) — the bridge owns both
mappings (device/tally.py "the bridge owns the slot<->value-id
mapping").
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

MAX_VALUE_ID = 2**31 - 1


class ValueTable:
    """payload bytes <-> value id.  Ids are content-derived (31-bit
    truncated SHA-512/256 of the payload) so independent hosts agree on
    ids without coordination; collisions fall back to probing, which
    stays host-local consistent for the payloads this host saw."""

    def __init__(self):
        self._by_id: Dict[int, bytes] = {}
        self._by_payload: Dict[bytes, int] = {}

    def intern(self, payload: bytes) -> int:
        vid = self._by_payload.get(payload)
        if vid is not None:
            return vid
        digest = hashlib.sha512(payload).digest()
        vid = int.from_bytes(digest[:4], "little") & MAX_VALUE_ID
        while vid in self._by_id and self._by_id[vid] != payload:
            vid = (vid + 1) & MAX_VALUE_ID       # linear probe
        self._by_id[vid] = payload
        self._by_payload[payload] = vid
        return vid

    def payload(self, vid: int) -> Optional[bytes]:
        return self._by_id.get(vid)

    def __len__(self) -> int:
        return len(self._by_id)


class SlotMap:
    """Per-instance dense slot allocation for value ids.

    `n_slots` is the tally's static S; at most S distinct non-nil
    values can be tracked per instance window.  Overflowing values get
    slot None — the caller routes those votes to the host tally
    (the documented host-fallback path for adversarial many-value
    floods, SURVEY.md §7 hard part 2)."""

    def __init__(self, n_instances: int, n_slots: int):
        self.n_slots = n_slots
        self._maps: List[Dict[int, int]] = [dict()
                                            for _ in range(n_instances)]
        self.overflowed: int = 0
        # dense [I, S] slot -> value-id export (-1 = unallocated),
        # maintained incrementally so a native densify drain can scan
        # it by POINTER — value ids are 31-bit non-negative, so -1 is a
        # safe sentinel.  numpy is imported lazily to keep this
        # module's import surface unchanged for the table-only users.
        import numpy as _np
        self.dense = _np.full((n_instances, n_slots), -1, _np.int64)

    def slot_for(self, instance: int, value_id: int) -> Optional[int]:
        m = self._maps[instance]
        slot = m.get(value_id)
        if slot is not None:
            return slot
        if len(m) >= self.n_slots:
            self.overflowed += 1
            return None
        slot = len(m)
        m[value_id] = slot
        self.dense[instance, slot] = value_id
        return slot

    def prealloc(self, instance: int, value_id: int) -> None:
        """Allocate a slot if there is room; unlike slot_for, a full
        map is NOT counted as an overflow attempt.  Used by batch
        pre-passes that fix allocation ORDER (combined ascending across
        vote classes) before the per-class interning that does the real
        per-vote accounting."""
        m = self._maps[instance]
        if value_id not in m and len(m) < self.n_slots:
            self.dense[instance, len(m)] = value_id
            m[value_id] = len(m)

    def value_for(self, instance: int, slot: int) -> Optional[int]:
        for vid, s in self._maps[instance].items():
            if s == slot:
                return vid
        return None

    def reset_instance(self, instance: int) -> None:
        """Free an instance's slots (height advance)."""
        self._maps[instance].clear()
        self.dense[instance, :] = -1
