"""VerifiedCache: the serve plane's verified-vote dedup layer (twin of
`agnes_tpu.serve.cache`).

Gossip delivers every vote O(peers) times, and without this layer each
re-delivery pays a verify lane on the card.  A bounded, thread-safe map
keyed by the SHA-256 of the 96-byte wire record is consulted at
admission (serve/queue.py): a hit (the exact bytes were verified on the
card before) admits the record pre-verified, and the pipeline routes it
to the verify-free unsigned step; a miss flows to the fused verify.

Poisoning safety is the design:

* Entries are inserted only after the verify of their dispatch settles
  clean (`ServePipeline.settle`).  The card reports a rejected-lane
  count, not per-lane verdicts, so a dispatch with any rejected lane
  caches nothing (`insert_skipped_rejected`): a replayed rejected
  signature pays the verify every time and is never cached.
* A hit proves "identical bytes passed the verify", and verification is
  a pure function of the record's bytes, so replaying a hit through the
  unsigned step cannot change any verdict.

Bounded by an LRU byte budget (`max_bytes`, `ENTRY_BYTES` a entry) and
by `prune_decided` (a vote for a decided height can never reach a verify
lane again).  Pure stdlib + numpy; one leaf mutex around dict work.
"""

from __future__ import annotations

import collections
import threading
from typing import Optional

import numpy as np

#: accounted bytes per entry: 32-byte digest key + dict slot + the
#: (instance, height) value tuple, rounded up
ENTRY_BYTES = 128

#: default budget: ~512k entries
DEFAULT_MAX_BYTES = 64 * 1024 * 1024


class VerifiedCache:
    """Bounded thread-safe digest -> (instance, height) LRU map
    (module docstring).  All arrays are host numpy."""

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES):
        if int(max_bytes) < ENTRY_BYTES:
            raise ValueError(
                f"max_bytes must hold at least one entry "
                f"({ENTRY_BYTES}): {max_bytes}")
        self.max_bytes = int(max_bytes)
        self._mu = threading.Lock()
        # digest bytes -> (instance, height); order = LRU (oldest first)
        self._entries: "collections.OrderedDict[bytes, tuple]" = \
            collections.OrderedDict()
        # instance -> height -> set of keys: the pruning index
        self._by_inst: dict = {}
        self.counters = {
            "hits": 0, "misses": 0, "inserted": 0, "evicted": 0,
            "pruned_height": 0, "insert_skipped_rejected": 0,
            "insert_skipped_noverdict": 0,
        }
        self._last_prune: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes(self) -> int:
        """Accounted resident size (ENTRY_BYTES per entry)."""
        return len(self._entries) * ENTRY_BYTES

    # -- admission-side -------------------------------------------------------

    def lookup(self, digests: np.ndarray) -> np.ndarray:
        """[N] bool hit mask for [N, 32] uint8 digests.  Hits refresh
        LRU recency; hit/miss counters move per record."""
        n = len(digests)
        out = np.zeros(n, bool)
        if n == 0:
            return out
        keys = [digests[j].tobytes() for j in range(n)]
        with self._mu:
            entries = self._entries
            for j, key in enumerate(keys):
                if key in entries:
                    entries.move_to_end(key)
                    out[j] = True
            hits = int(out.sum())
            self.counters["hits"] += hits
            self.counters["misses"] += n - hits
        return out

    # -- settle-side ----------------------------------------------------------

    def insert(self, digests: np.ndarray, instances: np.ndarray,
               heights: np.ndarray) -> int:
        """Insert verified records (only after the dispatch that carried
        them settled with zero rejected lanes).  Returns entries newly
        inserted; evicts LRU past `max_bytes`."""
        n = len(digests)
        if n == 0:
            return 0
        budget = self.max_bytes // ENTRY_BYTES
        items = [(digests[j].tobytes(),
                  (int(instances[j]), int(heights[j])))
                 for j in range(n)]
        with self._mu:
            entries = self._entries
            new = 0
            for key, val in items:
                old = entries.get(key)
                if old is None:
                    new += 1
                elif old != val:
                    self._index_discard(key, old)
                entries[key] = val
                entries.move_to_end(key)
                if old is None or old != val:
                    self._by_inst.setdefault(val[0], {}) \
                        .setdefault(val[1], set()).add(key)
            evicted = 0
            while len(entries) > budget:
                key, val = entries.popitem(last=False)
                self._index_discard(key, val)
                evicted += 1
            self.counters["inserted"] += new
            self.counters["evicted"] += evicted
        return new

    def _index_discard(self, key: bytes, val: tuple) -> None:
        """Drop one key from the pruning index (mutex held)."""
        hts = self._by_inst.get(val[0])
        if hts is None:
            return
        bucket = hts.get(val[1])
        if bucket is not None:
            bucket.discard(key)
            if not bucket:
                del hts[val[1]]
        if not hts:
            del self._by_inst[val[0]]

    def note_rejected_batch(self) -> None:
        """A settled dispatch carried rejected lanes: its candidate
        entries were all discarded."""
        with self._mu:
            self.counters["insert_skipped_rejected"] += 1

    def note_unverified_batch(self) -> None:
        """A settled signed dispatch carried no reject verdict: nothing
        inserted (fail closed)."""
        with self._mu:
            self.counters["insert_skipped_noverdict"] += 1

    # -- state-space surface --------------------------------------------------

    def mc_clone(self) -> "VerifiedCache":
        """Copy with a fresh mutex, the entry map (LRU order kept) and
        the pruning index."""
        c = VerifiedCache(self.max_bytes)
        with self._mu:
            c._entries = collections.OrderedDict(self._entries)
            c._by_inst = {i: {h: set(s) for h, s in hts.items()}
                          for i, hts in self._by_inst.items()}
            c.counters = dict(self.counters)
            c._last_prune = None if self._last_prune is None \
                else self._last_prune.copy()
        return c

    def mc_canonical(self) -> tuple:
        """Entries in LRU order (recency picks eviction victims)."""
        with self._mu:
            return tuple((k, v[0], v[1])
                         for k, v in self._entries.items())

    # -- pruning --------------------------------------------------------------

    def prune_decided(self, heights: np.ndarray) -> int:
        """Drop entries whose height is below their instance's current
        height.  `heights` is the batcher's [I] view; out-of-range
        instances are left alone.  O(entries pruned): the per-instance
        index names the dead buckets, and instances whose height did
        not move since the last call are skipped."""
        hts = np.asarray(heights)
        n_inst = len(hts)
        pruned = 0
        with self._mu:
            prev = self._last_prune
            for inst, buckets in list(self._by_inst.items()):
                if not 0 <= inst < n_inst:
                    continue
                h_now = int(hts[inst])
                if prev is not None and inst < len(prev) \
                        and int(prev[inst]) == h_now:
                    continue
                for h in [h for h in buckets if h < h_now]:
                    for key in buckets.pop(h):
                        self._entries.pop(key, None)
                        pruned += 1
                if not buckets:
                    del self._by_inst[inst]
            self._last_prune = hts.copy()
            self.counters["pruned_height"] += pruned
        return pruned

    # -- reporting ------------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        with self._mu:
            h, m = self.counters["hits"], self.counters["misses"]
        return h / (h + m) if h + m else 0.0

    def snapshot(self) -> dict:
        with self._mu:
            out = dict(self.counters)
            out["entries"] = len(self._entries)
        out["bytes"] = out["entries"] * ENTRY_BYTES
        out["hit_rate"] = round(
            out["hits"] / (out["hits"] + out["misses"]), 4) \
            if out["hits"] + out["misses"] else 0.0
        return out
