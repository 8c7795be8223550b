"""Serve-plane admission model checker (twin of
`agnes_tpu.analysis.admission_mc`, over the port's serve plane).

The admission/batching layer — AdmissionQueue fairness caps + overload
policies, the held-vote window, the dedup split-rung dispatch — is the
largest body of decision-affecting host code that without this module
has NO exhaustive coverage: it is differential-tested on sampled
traffic and unit-tested on hand-picked scenarios, exactly the coverage
profile the bounded model checker was built to close for the consensus
core.

This module drives the SAME schedule enumerator (`modelcheck.Domain` /
`_explore_domain`: depth-bounded DFS, canonical-state dedup, ddmin
minimization) over an `AdmissionSystem`:

  * the REAL `serve.queue.AdmissionQueue` and REAL
    `serve.cache.VerifiedCache` (their `mc_clone`/`mc_canonical`
    hooks are the only serve/ additions) — the admission code under
    check is production code, not a re-model;
  * a deterministic MODEL of the batcher/pipeline stages downstream
    (pending queue, held-vote window, builds capped at `max_rung`,
    the verified/fresh split, preverified chunking to <= 2 vote
    phases) — the real VoteBatcher/ServePipeline launch device
    steps, and a model state must clone in microseconds.  Model
    counterexamples replay through the real VoteService, on the CPU
    in the tests and on the card in chip_smoke.py.

Actions (the admission schedule alphabet):

  ("s", k)   submit one copy of record template k (bounded per
             template by `max_copies` — gossip duplication included:
             copies are byte-identical, so the dedup cache sees them)
  ("b",)     one pump tick: drain <= `target` records FIFO, build
             capped split builds, dispatch them, age what waited
  ("v",)     settle the oldest unsettled signed dispatch: its wire
             digests become dedup-cache entries (clean-verify model)
  ("w",)     advance the window round once: held future-round rows
             become buildable (the held re-entry path)

Property monitors (the admission-soundness contract):

  conservation   no admitted record is ever lost outside a counted
                 reject: per template, admitted == still-queued +
                 pending + dispatched
  starvation     fairness caps never starve an admitted in-window
                 record forever: its pump-tick age is bounded by
                 `starve_bound` (FIFO drains guarantee it; a
                 reordering/skipping queue violates it)
  pbound         every dispatch is entry + <= 2 vote phases — P in
                 {2, 3}, the warmed-shape contract (an unchunked
                 preverified burst is a live compile stall in
                 production)
  purity         rows in an UNSIGNED (preverified) dispatch carry
                 only dedup-cache-hit digests — a fresh row on a
                 verify-free entry would skip signature verification
                 entirely (the dedup cache's security invariant)

The mutation registry (`ADMISSION_MUTANTS`) doctors one stage each —
a record-dropping drain, a LIFO (newest-first) drain, an unchunked
preverified build, a taint-splitting build — and `self_test_admission`
proves every monitor has teeth: caught, ddmin-minimized, minimized
schedule clean on the honest model.

Numpy + stdlib over the port's queue, cache and class table (which
import torch); no jax and nothing of `agnes_tpu` (asserted by test).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from agnes_tpu_torch.analysis.modelcheck import (
    Domain,
    Report,
    Violation,
    _ddmin,
    _explore_domain,
)
from agnes_tpu_torch.bridge.native_ingest import pack_wire_votes
from agnes_tpu_torch.serve.cache import VerifiedCache
from agnes_tpu_torch.serve.queue import AdmissionQueue

ADMISSION_PROPERTIES = ("conservation", "starvation", "pbound", "purity")

#: The class-bucket extension reuses "conservation" (every
#: FOLDED share is in exactly one of open-class / aggregate-dispatched
#: / fallback-dispatched / forged-dropped) and "purity" (an aggregate
#: dispatch may carry only a pairing-CLEARED class); the pairing
#: verdict itself is an oracle boundary (crypto, not admission), so
#: the model declares it per validator via `bls_forged` — the honest
#: close routes forged classes down the per-share fallback exactly
#: like serve/bls_lane.BlsLane.clear_classes.

#: template = (instance, validator, round, typ); the wire value id is
#: 100 + template index, which is how drained rows are re-identified
_DEFAULT_TEMPLATES = (
    (0, 0, 0, 0),      # instance 0, round 0, prevote
    (0, 1, 0, 1),      # instance 0, round 0, precommit
    (1, 2, 0, 0),      # instance 1, round 0, prevote
    (1, 3, 1, 0),      # instance 1, round 1, prevote (held until "w")
)


@dataclasses.dataclass(frozen=True)
class AdmissionMCConfig:
    """One bounded admission-exploration task.  JSON-able (spawn
    workers, corpus files)."""

    name: str
    n_instances: int = 2
    capacity: int = 6
    instance_cap: Optional[int] = None
    policy: str = "reject_newest"
    target: int = 3            # micro-batch drain size per pump tick
    max_rung: int = 4          # build cap (the ladder's top rung)
    dedup: bool = True
    depth: int = 12
    max_copies: int = 2        # per-template submission bound
    starve_bound: int = 4      # eligible-age bound (pump ticks)
    window_rounds: int = 1     # how many ("w",) advances exist
    templates: Tuple[Tuple[int, int, int, int], ...] = _DEFAULT_TEMPLATES
    # -- BLS class-bucket mode --------------------------------------------
    bls: bool = False
    #: BLS share templates: (instance, validator, typ) at height 0,
    #: round 0 — each (instance, typ) pair is one aggregate class
    bls_templates: Tuple[Tuple[int, int, int], ...] = ()
    bls_target: int = 2        # class size-close threshold (poll)
    bls_max_classes: int = 2   # BlsClassTable bound
    #: validators whose shares fail the (modeled) pairing — the honest
    #: close falls their class back to per-share dispatch
    bls_forged: Tuple[int, ...] = ()
    #: validators without a verified proof of possession — their folds
    #: are rejected at admission (bls_pop_missing)
    bls_no_pop: Tuple[int, ...] = ()

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["templates"] = [list(t) for t in self.templates]
        d["bls_templates"] = [list(t) for t in self.bls_templates]
        d["bls_forged"] = list(self.bls_forged)
        d["bls_no_pop"] = list(self.bls_no_pop)
        d["kind"] = "admission"
        return d

    @classmethod
    def from_json(cls, d: dict) -> "AdmissionMCConfig":
        d = dict(d)
        d.pop("kind", None)
        d["templates"] = tuple(tuple(t) for t in d["templates"])
        d["bls_templates"] = tuple(
            tuple(t) for t in d.get("bls_templates", ()))
        d["bls_forged"] = tuple(d.get("bls_forged", ()))
        d["bls_no_pop"] = tuple(d.get("bls_no_pop", ()))
        return cls(**d)


_ACT_NAMES = {"s": "submit", "b": "pump", "v": "settle", "w": "window",
              "f": "fold", "c": "classes"}
_ACT_CODES = {v: k for k, v in _ACT_NAMES.items()}


class _McBlsRegistry:
    """Stub BlsKeyRegistry surface for the class table (V / powers /
    pop_ok / epoch) — the REAL registry decompresses every pubkey and
    packs device limbs, which a model state must not pay for.
    The table under check is the production BlsClassTable."""

    def __init__(self, n_validators: int, no_pop=()):
        self.V = int(n_validators)
        self.powers = np.ones(self.V, np.int64)
        self.pop_ok = np.ones(self.V, bool)
        self.pop_ok[list(no_pop)] = False
        self.forged_strikes = np.zeros(self.V, np.int64)
        self.quarantined = np.zeros(self.V, bool)
        self.epoch = 0


@functools.lru_cache(maxsize=256)
def _bls_share_bytes(idx: int) -> bytes:
    """A VALID (on-twist, non-identity) 192-byte G2 share per template
    index, so the fold's decode screen passes on the real path — not a
    valid signature: the pairing verdict is modeled (`bls_forged`),
    never computed.  Pure python (bls_ref)."""
    from agnes_tpu_torch.crypto import bls_ref as ref

    return ref.g2_to_bytes(ref.point_mul(2 + idx, ref.G2))


@functools.lru_cache(maxsize=256)
def _pack_template(tmpl: Tuple[int, int, int, int]) -> bytes:
    """One SIGNED 96-byte wire record for a template: value id is
    100 + instance (one value per instance — the honest dense shape
    VoteBatcher._device_verify_eligible demands, so the serve replay's
    fresh builds keep the signed-lane path), signature REAL over the
    fixture seed scheme (deterministic_seeds) so host-fallback subsets
    verify instead of silently dropping.  The pure-Python ref signer
    needs no C++ build (RFC 8032 signatures are deterministic, so they
    equal the host signer's); memoized — ddmin rebuilds a system per
    probe and must not re-pay ~ms/signature."""
    from agnes_tpu_torch.crypto.ed25519_ref import sign as _ref_sign
    from agnes_tpu_torch.crypto.encoding import vote_signing_bytes

    inst, val, rnd, typ = tmpl
    value = 100 + inst
    seed = val.to_bytes(4, "little") + bytes(28)
    sig = np.frombuffer(_ref_sign(seed, vote_signing_bytes(
        0, rnd, typ, value)), np.uint8)[None]
    return bytes(pack_wire_votes(
        np.asarray([inst], np.int64), np.asarray([val], np.int64),
        np.zeros(1, np.int64), np.asarray([rnd], np.int64),
        np.asarray([typ], np.int64),
        np.asarray([value], np.int64), sig))


@dataclasses.dataclass
class _Row:
    """One admitted record inside the model batcher's pending stage."""

    template: int
    verified: bool
    age: int


class AdmissionSystem:
    """The checkable system: real queue + real cache + modeled
    batcher/pipeline (module docstring).  Provides the engine's
    mc_clone / mc_apply / mc_enabled / mc_digest surface plus the
    schedule codec (`action_to_json`/`action_from_json`)."""

    #: stage classes — the mutation seams (ADMISSION_MUTANTS)
    queue_cls = AdmissionQueue
    bls_table_cls = None       # default: serve.bls_lane.BlsClassTable
    #: chunk preverified builds to <= this many vote phases (the
    #: honest pipeline's _stage_preverified bound)
    preverified_chunk = 2

    def __init__(self, cfg: AdmissionMCConfig):
        self.cfg = cfg
        assert len(set(cfg.templates)) == len(cfg.templates), \
            "templates must be distinct (identity is the full tuple)"
        cache = VerifiedCache() if cfg.dedup else None
        self.bls_table = None
        if cfg.bls:
            from agnes_tpu_torch.serve.bls_lane import BlsClassTable

            assert len(set(cfg.bls_templates)) == len(cfg.bls_templates)
            reg = _McBlsRegistry(
                1 + max(t[1] for t in cfg.bls_templates),
                no_pop=cfg.bls_no_pop)
            table_cls = self.bls_table_cls or BlsClassTable
            self.bls_table = table_cls(
                reg, cfg.n_instances,
                max_classes=cfg.bls_max_classes, clock=lambda: 0.0)
        self.queue = self.queue_cls(
            cfg.n_instances, cfg.capacity,
            instance_cap=cfg.instance_cap, policy=cfg.policy,
            cache=cache, bls_table=self.bls_table, clock=lambda: 0.0)
        self.cache = cache
        T = len(cfg.templates)
        # template identity: the (instance, validator, round, typ)
        # tuple — NOT the value id, which is one-per-instance so the
        # serve replay's fresh builds stay device-verify eligible
        # (VoteBatcher._device_verify_eligible: at most one distinct
        # non-nil value per instance)
        self._tmpl_key = {t: k for k, t in enumerate(cfg.templates)}
        self._wire = [self._pack(k) for k in range(T)]
        self.submits = [0] * T
        self.admitted = [0] * T
        self.dispatched = [0] * T
        # drop_oldest only: admitted records the queue SHED (counted
        # per template via the before/after queue diff at submit time)
        self.evicted = [0] * T
        # per-template FIFO of queued-record ages (the starvation
        # clock; rows are re-identified by the value column)
        self.q_ages: List[List[int]] = [[] for _ in range(T)]
        self.pending: List[_Row] = []
        self.window_round = 0
        # signed dispatches whose digests await a ("v",) settle:
        # FIFO of [(template, digest bytes, instance)]
        self.unsettled: List[List[tuple]] = []
        # (P, signed, per-template counts, rows) per dispatch — the
        # edge monitors' subject; history, excluded from the digest
        self.dispatch_log: List[tuple] = []
        # -- BLS class-bucket stage ---------------------------------------
        B = len(cfg.bls_templates)
        self._bls_key = {t: k for k, t in enumerate(cfg.bls_templates)}
        self._bls_wire = [self._pack_bls(k) for k in range(B)]
        self.bls_submits = [0] * B
        self.bls_folded = [0] * B          # accepted folds, per template
        self.bls_agg = [0] * B             # aggregate-dispatched
        self.bls_fallback = [0] * B        # fallback-dispatched (good)
        self.bls_dropped = [0] * B         # forged, dropped at fallback
        # ("agg"|"fallback", member templates, forged templates) per
        # class close — the purity edge monitor's subject
        self.bls_dispatch_log: List[tuple] = []

    # -- wire records --------------------------------------------------------

    def _pack(self, k: int) -> bytes:
        return _pack_template(self.cfg.templates[k])

    def _pack_bls(self, k: int) -> bytes:
        from agnes_tpu_torch.serve.bls_lane import pack_bls_wire

        inst, val, typ = self.cfg.bls_templates[k]
        share = np.frombuffer(_bls_share_bytes(k), np.uint8)[None]
        return pack_bls_wire(
            np.asarray([inst], np.int64), np.asarray([val], np.int64),
            np.zeros(1, np.int64), np.zeros(1, np.int64),
            np.asarray([typ], np.int64),
            np.asarray([100 + inst], np.int64), share)

    def _in_window(self, k: int) -> bool:
        return self.cfg.templates[k][2] <= self.window_round

    def _queued_counts(self) -> List[int]:
        """Per-template row count actually inside the REAL queue (from
        its canonical rows, never the model's own mirrors — a lossy
        queue must not be able to fool the conservation check)."""
        counts = [0] * len(self.cfg.templates)
        for (inst, val, _h, rnd, typ, _value, _v) \
                in self.queue.mc_canonical()[0]:
            k = self._tmpl_key.get((inst, val, rnd, typ))
            if k is not None:
                counts[k] += 1
        return counts

    # -- engine surface ------------------------------------------------------

    def mc_enabled(self) -> List[tuple]:
        acts: List[tuple] = []
        for k in range(len(self.cfg.templates)):
            if self.submits[k] < self.cfg.max_copies:
                acts.append(("s", k))
        if self.queue.depth > 0 or self.pending:
            acts.append(("b",))
        if self.unsettled:
            acts.append(("v",))
        if self.window_round < self.cfg.window_rounds:
            acts.append(("w",))
        for k in range(len(self.cfg.bls_templates)):
            if self.bls_submits[k] < self.cfg.max_copies:
                acts.append(("f", k))
        if self.bls_table is not None and self.bls_table.open_classes:
            acts.append(("c",))
        return acts

    def mc_apply(self, act: tuple) -> bool:
        kind = act[0]
        if kind == "s":
            k = act[1]
            if self.submits[k] >= self.cfg.max_copies:
                return False
            self.submits[k] += 1
            # drop_oldest is the ONLY policy that sheds queued rows at
            # submit time; the per-template eviction diff exists for
            # it alone.  Under reject_newest the diff is skipped — so
            # a doctored queue losing rows on submit surfaces as a
            # CONSERVATION violation instead of being misclassified as
            # eviction (and the hot smoke shard skips two O(queue)
            # walks per submit)
            diff = self.queue.policy == "drop_oldest"
            before = self._queued_counts() if diff else None
            res = self.queue.submit(self._wire[k])
            if res.accepted:
                self.admitted[k] += 1
                self.q_ages[k].append(0)
            if diff:
                # shed OLDEST copies carry the largest ages
                after = self._queued_counts()
                for t in range(len(self.cfg.templates)):
                    gone = before[t] - after[t] \
                        + (res.accepted if t == k else 0)
                    for _ in range(gone):
                        self.evicted[t] += 1
                        if self.q_ages[t]:
                            self.q_ages[t].remove(max(self.q_ages[t]))
            return True
        if kind == "b":
            if self.queue.depth == 0 and not self.pending:
                return False
            self._pump()
            return True
        if kind == "v":
            if not self.unsettled:
                return False
            batch = self.unsettled.pop(0)
            if self.cache is not None and batch:
                dig = np.stack([np.frombuffer(d, np.uint8)
                                for _k, d, _i in batch])
                inst = np.asarray([i for _k, _d, i in batch], np.int64)
                self.cache.insert(dig, inst, np.zeros(len(batch),
                                                      np.int64))
            return True
        if kind == "w":
            if self.window_round >= self.cfg.window_rounds:
                return False
            self.window_round += 1
            return True
        if kind == "f":
            k = act[1]
            if self.bls_submits[k] >= self.cfg.max_copies:
                return False
            self.bls_submits[k] += 1
            res = self.queue.submit_bls(self._bls_wire[k])
            if res.accepted:
                self.bls_folded[k] += 1
            return True
        if kind == "c":
            if self.bls_table is None \
                    or not self.bls_table.open_classes:
                return False
            self._close_classes()
            return True
        raise ValueError(f"unknown admission action {act!r}")

    # -- the pump tick (drain -> split -> build -> dispatch -> age) ----------

    def _pump(self) -> None:
        batch = self.queue.drain(self.cfg.target) \
            if self.queue.depth else None
        if batch is not None:
            for j in range(len(batch)):
                k = self._tmpl_key.get(
                    (int(batch.instance[j]), int(batch.validator[j]),
                     int(batch.round_[j]), int(batch.typ[j])))
                if k is None:
                    continue       # foreign record: conservation's job
                # copies of one template are byte-identical, so which
                # copy left is unobservable: assume FIFO-optimally
                # that the OLDEST (largest age) one did.  Honest FIFO
                # drains truly do; a reordering queue is caught via
                # DISTINCT templates (the starve mutant config)
                age = max(self.q_ages[k], default=0)
                if self.q_ages[k]:
                    self.q_ages[k].remove(age)
                self.pending.append(_Row(k, bool(batch.verified[j]),
                                         age))
        pre, fresh = self._split(self.pending)
        held: List[_Row] = []
        buildable: List[_Row] = []
        for r in fresh:
            (buildable if self._in_window(r.template)
             else held).append(r)
        # fresh builds: capped FIFO slices, grouped by (round, typ),
        # <= 2 vote-phase groups per dispatch (the signed entry-phase
        # shape; a wider tick stages several dispatches)
        while buildable:
            take, buildable = buildable[:self.cfg.max_rung], \
                buildable[self.cfg.max_rung:]
            self._dispatch(take, signed=True)
        pre_buildable = [r for r in pre if self._in_window(r.template)]
        pre_held = [r for r in pre if not self._in_window(r.template)]
        while pre_buildable:
            take, pre_buildable = pre_buildable[:self.cfg.max_rung], \
                pre_buildable[self.cfg.max_rung:]
            self._dispatch(take, signed=False)
        self.pending = held + pre_held
        # age every record still waiting while eligible (in-window)
        for k, ages in enumerate(self.q_ages):
            if self._in_window(k):
                self.q_ages[k] = [a + 1 for a in ages]
        for r in self.pending:
            if self._in_window(r.template):
                r.age += 1

    #: mutation seam: a True here dispatches EVERY closed class as a
    #: cleared aggregate, forged shares included (the purity mutant)
    bls_pairing_blind = False

    def _close_classes(self) -> None:
        """One class-close tick: size-closed classes leave the table
        and dispatch — pairing-CLEARED classes as ONE aggregate,
        classes containing a (declared) forged share down the
        per-share fallback with the forged shares dropped and the
        honest remainder dispatched — the BlsLane.clear_classes
        routing, with the pairing verdict read from `bls_forged`."""
        closed = self.bls_table.poll(
            now=0.0, target_signers=self.cfg.bls_target,
            max_delay_s=1e9)
        forged = set(self.cfg.bls_forged)
        for cls in closed:
            inst, _h, _r, typ, _val = cls.key
            members, bad = [], []
            for v in sorted(cls.shares):
                k = self._bls_key.get((inst, v, typ))
                if k is None:
                    continue
                (bad if v in forged else members).append(k)
            if not bad or self.bls_pairing_blind:
                for k in members + bad:
                    self.bls_agg[k] += 1
                self.bls_dispatch_log.append(
                    ("agg", tuple(members + bad), tuple(bad)))
            else:
                for k in members:
                    self.bls_fallback[k] += 1
                for k in bad:
                    self.bls_dropped[k] += 1
                self.bls_dispatch_log.append(
                    ("fallback", tuple(members), tuple(bad)))

    def _split(self, rows: List[_Row]) -> Tuple[List[_Row], List[_Row]]:
        """Partition pending into (pre-verified, fresh), preserving
        FIFO order — the honest VoteBatcher.split_pending_verified
        model.  A fresh row may NEVER land in the pre stream."""
        if self.cache is None:
            return [], list(rows)
        pre = [r for r in rows if r.verified]
        return pre, [r for r in rows if not r.verified]

    @staticmethod
    def _groups(rows: List[_Row], cfg) -> List[List[_Row]]:
        by: Dict[tuple, List[_Row]] = {}
        for r in rows:
            t = cfg.templates[r.template]
            by.setdefault((t[2], t[3]), []).append(r)
        return [by[k] for k in sorted(by)]

    def _dispatch(self, rows: List[_Row], signed: bool) -> None:
        """Chunked dispatch: every staged step sequence is entry +
        <= 2 vote phases — the warmed-shape discipline (fresh signed
        builds via the eligibility gate, preverified unsigned builds
        via _stage_preverified's chunking, serve/pipeline.py)."""
        import hashlib

        groups = self._groups(rows, self.cfg)
        step = 2 if signed else self.preverified_chunk
        for i in range(0, len(groups), step):
            chunk = groups[i:i + step]
            flat = [r for g in chunk for r in g]
            self._log_dispatch(len(chunk) + 1, signed, flat)
            if signed and self.cache is not None:
                entry = []
                for r in flat:
                    dig = hashlib.sha256(
                        self._wire[r.template]).digest()
                    entry.append((r.template, dig,
                                  self.cfg.templates[r.template][0]))
                self.unsettled.append(entry)

    def _log_dispatch(self, P: int, signed: bool,
                      rows: List[_Row]) -> None:
        counts = [0] * len(self.cfg.templates)
        for r in rows:
            counts[r.template] += 1
            self.dispatched[r.template] += 1
        self.dispatch_log.append(
            (P, signed, tuple(counts),
             tuple((r.template, r.verified) for r in rows)))

    # -- branching / dedup ---------------------------------------------------

    def mc_clone(self) -> "AdmissionSystem":
        s = type(self).__new__(type(self))
        s.cfg = self.cfg
        s.cache = None if self.cache is None else self.cache.mc_clone()
        s.queue = self.queue.mc_clone()
        s.queue.cache = s.cache
        s.bls_table = (None if self.bls_table is None
                       else self.bls_table.mc_clone())
        s.queue.bls_table = s.bls_table
        s._bls_key = self._bls_key
        s._bls_wire = self._bls_wire
        s.bls_submits = list(self.bls_submits)
        s.bls_folded = list(self.bls_folded)
        s.bls_agg = list(self.bls_agg)
        s.bls_fallback = list(self.bls_fallback)
        s.bls_dropped = list(self.bls_dropped)
        s.bls_dispatch_log = list(self.bls_dispatch_log)
        s._wire = self._wire
        s._tmpl_key = self._tmpl_key
        s.submits = list(self.submits)
        s.admitted = list(self.admitted)
        s.dispatched = list(self.dispatched)
        s.evicted = list(self.evicted)
        s.q_ages = [list(a) for a in self.q_ages]
        s.pending = [_Row(r.template, r.verified, r.age)
                     for r in self.pending]
        s.window_round = self.window_round
        s.unsettled = [list(b) for b in self.unsettled]
        s.dispatch_log = list(self.dispatch_log)
        return s

    def mc_canonical(self) -> tuple:
        return (
            tuple(self.submits),
            tuple(self.admitted),
            tuple(self.dispatched),
            tuple(self.evicted),
            self.queue.mc_canonical(),
            None if self.cache is None else self.cache.mc_canonical(),
            tuple(tuple(a) for a in self.q_ages),
            tuple((r.template, r.verified, r.age)
                  for r in self.pending),
            self.window_round,
            tuple(tuple((k, i) for k, _d, i in b)
                  for b in self.unsettled),
            None if self.bls_table is None
            else (self.bls_table.mc_canonical(),
                  tuple(self.bls_submits), tuple(self.bls_folded),
                  tuple(self.bls_agg), tuple(self.bls_fallback),
                  tuple(self.bls_dropped)),
        )

    def mc_digest(self, perm=None) -> bytes:
        import hashlib
        import marshal

        assert perm is None, "admission domain has no symmetry group"
        return hashlib.blake2b(marshal.dumps(self.mc_canonical(), 2),
                               digest_size=16).digest()

    # -- schedule codec (the Counterexample/corpus serialization) ------------

    @classmethod
    def action_to_json(cls, act: tuple) -> list:
        return [_ACT_NAMES[act[0]], *act[1:]]

    @classmethod
    def action_from_json(cls, a: list) -> tuple:
        return (_ACT_CODES[a[0]], *(int(x) for x in a[1:]))

    def run_schedule(self, actions, on_action=None) -> List[bool]:
        applied = []
        for i, a in enumerate(actions):
            act = self.action_from_json(a) if a and a[0] in _ACT_CODES \
                else tuple(a)
            ok = self.mc_apply(act)
            applied.append(ok)
            if on_action is not None:
                on_action(i, act, ok)
        return applied


# ---------------------------------------------------------------------------
# Monitors
# ---------------------------------------------------------------------------


def admission_state_violations(sys: AdmissionSystem) -> List[Violation]:
    out: List[Violation] = []
    queued = sys._queued_counts()
    pend = [0] * len(sys.cfg.templates)
    for r in sys.pending:
        pend[r.template] += 1
    for k in range(len(sys.cfg.templates)):
        have = queued[k] + pend[k] + sys.dispatched[k] + sys.evicted[k]
        if have != sys.admitted[k]:
            out.append(Violation(
                "conservation", k,
                f"template {k}: admitted {sys.admitted[k]} != queued "
                f"{queued[k]} + pending {pend[k]} + dispatched "
                f"{sys.dispatched[k]} + evicted {sys.evicted[k]} — an "
                f"admitted vote was lost outside a counted reject"))
    bound = sys.cfg.starve_bound
    for k, ages in enumerate(sys.q_ages):
        for a in ages:
            if a > bound:
                out.append(Violation(
                    "starvation", k,
                    f"template {k}: queued record waited {a} pump "
                    f"ticks in-window (bound {bound})"))
                break
    for r in sys.pending:
        if sys._in_window(r.template) and r.age > bound:
            out.append(Violation(
                "starvation", r.template,
                f"template {r.template}: pending record waited "
                f"{r.age} pump ticks in-window (bound {bound})"))
            break
    if sys.bls_table is not None:
        # class-bucket conservation: every FOLDED share is
        # in exactly one of open-class / aggregate-dispatched /
        # fallback-dispatched / forged-dropped — read the open-class
        # counts from the REAL table's canonical rows, so a lossy fold
        # cannot vouch for itself
        open_counts = [0] * len(sys.cfg.bls_templates)
        for key, signers, _w in sys.bls_table.mc_canonical():
            inst, _h, _r, typ, _val = key
            for v in signers:
                k = sys._bls_key.get((inst, v, typ))
                if k is not None:
                    open_counts[k] += 1
        for k in range(len(sys.cfg.bls_templates)):
            have = (open_counts[k] + sys.bls_agg[k]
                    + sys.bls_fallback[k] + sys.bls_dropped[k])
            if have != sys.bls_folded[k]:
                out.append(Violation(
                    "conservation", k,
                    f"bls template {k}: folded {sys.bls_folded[k]} "
                    f"!= open {open_counts[k]} + aggregate "
                    f"{sys.bls_agg[k]} + fallback "
                    f"{sys.bls_fallback[k]} + dropped "
                    f"{sys.bls_dropped[k]} — a folded share was "
                    f"lost outside a counted path"))
    return out


def admission_edge_snapshot(sys: AdmissionSystem) -> tuple:
    return (len(sys.dispatch_log), len(sys.bls_dispatch_log))


def admission_edge_violations(sys: AdmissionSystem,
                              snap: tuple) -> List[Violation]:
    out: List[Violation] = []
    for kind, members, forged in sys.bls_dispatch_log[snap[1]:]:
        if kind == "agg" and forged:
            out.append(Violation(
                "purity", forged[0],
                f"aggregate dispatch carried a non-pairing-cleared "
                f"class (forged bls templates {sorted(forged)} "
                f"folded into the single aggregate lane)"))
    for P, signed, _counts, rows in sys.dispatch_log[snap[0]:]:
        if P not in (2, 3):
            out.append(Violation(
                "pbound", -1,
                f"dispatch with P={P} phases (entry + vote phases "
                f"outside the warmed {{2, 3}} set)"))
        if not signed:
            bad = [k for k, ver in rows if not ver]
            if bad:
                out.append(Violation(
                    "purity", bad[0],
                    f"unsigned (verify-free) dispatch carried "
                    f"non-cache-hit rows of templates {sorted(set(bad))}"))
    return out


def admission_domain() -> Domain:
    return Domain(
        enabled=lambda s: s.mc_enabled(),
        expandable=lambda s: True,
        state_violations=admission_state_violations,
        edge_snapshot=admission_edge_snapshot,
        edge_violations=admission_edge_violations,
        indep=lambda a, b: False,      # one shared queue: no POR
        near_miss=None,
        symmetry=None,
        codec=AdmissionSystem)


def explore_admission(cfg: AdmissionMCConfig,
                      system_cls: Optional[type] = None,
                      deadline_at: Optional[float] = None,
                      max_states: Optional[int] = None,
                      stop_on_violation: bool = True,
                      collect_digests: bool = False) -> Report:
    """Exhaustive DFS over `cfg`'s admission schedules — the same
    engine as the consensus scopes (`modelcheck._explore_domain`)."""
    root = (system_cls or AdmissionSystem)(cfg)
    return _explore_domain(
        root, cfg, admission_domain(), por=False,
        deadline_at=deadline_at, max_states=max_states,
        stop_on_violation=stop_on_violation,
        collect_digests=collect_digests)


# ---------------------------------------------------------------------------
# Replay + minimization + corpus
# ---------------------------------------------------------------------------


def run_admission_with_monitors(cfg: AdmissionMCConfig, actions,
                                system_cls: Optional[type] = None
                                ) -> Tuple[AdmissionSystem,
                                           List[Violation]]:
    """Deterministic replay with every monitor after every applied
    action — the reproduction predicate for ddmin and the corpus."""
    sys_ = (system_cls or AdmissionSystem)(cfg)
    viols: List[Violation] = list(admission_state_violations(sys_))
    snap = [admission_edge_snapshot(sys_)]

    def on_action(_i, _act, ok):
        if ok:
            viols.extend(admission_edge_violations(sys_, snap[0]))
            viols.extend(admission_state_violations(sys_))
        snap[0] = admission_edge_snapshot(sys_)

    sys_.run_schedule(actions, on_action=on_action)
    return sys_, viols


def admission_reproduces(cfg, actions, prop,
                         system_cls: Optional[type] = None) -> bool:
    _, viols = run_admission_with_monitors(cfg, actions, system_cls)
    return any(v.property == prop for v in viols)


def minimize_admission(cfg, actions, prop,
                       system_cls: Optional[type] = None) -> List[tuple]:
    return _ddmin(
        list(actions),
        lambda acts: admission_reproduces(cfg, acts, prop, system_cls))


def admission_corpus_entry(name: str, cfg: AdmissionMCConfig,
                           actions, origin: str) -> dict:
    """Corpus entry with the honest model's outcome stamped: the full
    dispatch log (P, signed, per-template counts) and the admission
    counters — the replay tests assert bit-stable behavior, and the
    serve-plane replay (tests/test_torch_admission_mc.py, chip_smoke.py
    phase 14) drives the REAL VoteService through the same schedule."""
    sys_, viols = run_admission_with_monitors(cfg, actions)
    return {
        "kind": "admission",
        "name": name,
        "origin": origin,
        "config": cfg.to_json(),
        "actions": [AdmissionSystem.action_to_json(tuple(a))
                    for a in actions],
        "expect": {
            "violations": sorted({v.property for v in viols}),
            "dispatches": [[p, s, list(c)]
                           for p, s, c, _rows in sys_.dispatch_log],
            "admitted": list(sys_.admitted),
            "dispatched": list(sys_.dispatched),
            "evicted": list(sys_.evicted),
            "queue_counters": {k: int(v)
                               for k, v in sys_.queue.counters.items()},
            "cache_hits": (0 if sys_.cache is None
                           else sys_.cache.counters["hits"]),
            "bls_dispatches": [[kind, list(m), list(f)]
                               for kind, m, f
                               in sys_.bls_dispatch_log],
            "bls_folded": list(sys_.bls_folded),
            "bls_table_counters": (
                {} if sys_.bls_table is None
                else {k: int(v) for k, v
                      in sys_.bls_table.counters.items()}),
        },
    }


def replay_admission_entry(entry: dict) -> Tuple[AdmissionSystem,
                                                 List[Violation]]:
    cfg = AdmissionMCConfig.from_json(entry["config"])
    sys_, viols = run_admission_with_monitors(cfg, entry["actions"])
    exp = entry["expect"]
    got = [[p, s, list(c)] for p, s, c, _r in sys_.dispatch_log]
    assert got == exp["dispatches"], (
        f"{entry['name']}: dispatch log diverged")
    assert list(sys_.admitted) == exp["admitted"], entry["name"]
    assert list(sys_.dispatched) == exp["dispatched"], entry["name"]
    assert list(sys_.evicted) == exp["evicted"], entry["name"]
    assert {k: int(v) for k, v in sys_.queue.counters.items()} \
        == exp["queue_counters"], entry["name"]
    got_bls = [[k, list(m), list(f)]
               for k, m, f in sys_.bls_dispatch_log]
    assert got_bls == exp.get("bls_dispatches", []), (
        f"{entry['name']}: bls dispatch log diverged")
    assert list(sys_.bls_folded) == exp.get("bls_folded", []), \
        entry["name"]
    if sys_.bls_table is not None:
        assert {k: int(v)
                for k, v in sys_.bls_table.counters.items()} \
            == exp["bls_table_counters"], entry["name"]
    assert sorted({v.property for v in viols}) == exp["violations"], (
        f"{entry['name']}: property verdicts diverged")
    return sys_, viols


# ---------------------------------------------------------------------------
# Serve-plane replay: a model schedule through the REAL VoteService
# ---------------------------------------------------------------------------


def admission_service(cfg: AdmissionMCConfig, device="cuda",
                      native_admission: bool = False,
                      hbm_bytes: Optional[int] = None):
    """A VoteService on `device` over the REAL queue, batcher and
    pipeline, shaped by `cfg`: one validator a template validator
    (fixture keys, the model's signing seeds), a 1-round batcher window
    so the model's held-vote semantics map onto the real hold-back
    path, and a window predictor the ("w",) action advances.  Returns
    (svc, window, dispatches, verifies): `window` is the predictor's [I]
    base height array, `dispatches` records every dispatch as (n_phases,
    unsigned, per-phase slot bytes) before it launches, and `verifies`
    the inputs of every Ed25519 verify the run asks for, in order, as
    (kind, pub, sig, blocks, real) on the service's device: kind
    "dispatch" for a signed dispatch's SignedLanes, "fallback" for the
    batcher's host-fallback `_verify` batch (`real` all true).  With
    the driver's default unchunked verify, each entry with a lane is
    one verify kernel launch on the card.  `hbm_bytes` is the ladder's
    memory budget, required on the CPU.
    BLS templates are not wired: no BLS lane is built."""
    import torch

    from agnes_tpu_torch.bridge.ingest import VoteBatcher
    from agnes_tpu_torch.harness.device_driver import DeviceDriver
    from agnes_tpu_torch.harness.fixtures import (
        deterministic_seeds,
        validator_pubkeys,
    )
    from agnes_tpu_torch.serve import ShapeLadder, VoteService

    I = cfg.n_instances
    V = max(t[1] for t in cfg.templates) + 1
    d = DeviceDriver(I, V, advance_height=True, defer_collect=True,
                     device=device)
    bat = VoteBatcher(I, V, n_slots=4, n_rounds=1, device=device)
    window = np.zeros(I, np.int64)
    svc = VoteService(
        d, bat, validator_pubkeys(deterministic_seeds(V)),
        dedup_cache=VerifiedCache() if cfg.dedup else None,
        capacity=cfg.capacity, instance_cap=cfg.instance_cap,
        overload_policy=cfg.policy, target_votes=cfg.target,
        max_delay_s=0.0, native_admission=native_admission,
        ladder=ShapeLadder.plan(I, V, min_rung=4, hbm_bytes=hbm_bytes),
        window_predictor=lambda: (window.copy(), np.zeros(I, np.int64)))
    dispatches: List[tuple] = []
    verifies: List[tuple] = []
    launch, check = d.step_async, bat._verify

    def recorded(phases, lanes=None, exts=None, tick=None):
        dispatches.append(
            (len(phases), lanes is None,
             tuple(p.slots.cpu().numpy().tobytes() for p in phases)))
        if lanes is not None:
            verifies.append(("dispatch", lanes.pub, lanes.sig,
                             lanes.blocks, lanes.real))
        return launch(phases, lanes, exts, tick=tick)

    def verify_recorded(b, pubkeys):
        pub, sig, blocks = (bat._to_device(a) for a in
                            bat._pack_verify_inputs_np(b, pubkeys))
        verifies.append(("fallback", pub, sig, blocks,
                         torch.ones(len(b), dtype=torch.bool,
                                    device=pub.device)))
        return check(b, pubkeys)

    d.step_async, bat._verify = recorded, verify_recorded
    return svc, window, dispatches, verifies


def drive_admission_service(svc, window: np.ndarray, cfg: AdmissionMCConfig,
                            actions) -> List[object]:
    """Drive `admission_service`'s service through a schedule: submit /
    pump / settle / window map onto `submit`, one closed micro-batch
    pumped and dispatched, `poll_decisions`, and a window advance; the
    BLS actions ("f", "c") have no serve counterpart here and are
    skipped.  Returns the decisions polled."""
    wire = AdmissionSystem(cfg)._wire
    decisions: List[object] = []
    for a in actions:
        act = AdmissionSystem.action_from_json(a) \
            if a and a[0] in _ACT_CODES else tuple(a)
        if act[0] == "s":
            svc.submit(wire[act[1]])
        elif act[0] == "b":
            svc._pump_batch(svc._close_batch())
            svc.pipeline.dispatch_staged()
        elif act[0] == "v":
            decisions += svc.poll_decisions()
        elif act[0] == "w":
            window += 1
    return decisions


# ---------------------------------------------------------------------------
# Mutation self-test: doctored stages the monitors MUST catch
# ---------------------------------------------------------------------------


class _LossyDrainQueue(AdmissionQueue):
    """Doctored: drain sheds the LAST drained record without counting
    it anywhere — the classic off-by-one at a split boundary."""

    def drain(self, max_records=None):
        batch = super().drain(max_records)
        if batch is None or len(batch) == 0:
            return batch
        return type(batch)(*[c[:-1] for c in batch[:8]],
                           digest=(None if batch.digest is None
                                   else batch.digest[:-1]),
                           t_first=batch.t_first)


class _LifoDrainQueue(AdmissionQueue):
    """Doctored: drains NEWEST records first — under sustained load
    the oldest admitted record waits forever (starvation).  Builds
    fresh reversed chunks rather than mutating the deque's (chunk
    objects are shared across mc_clone branches)."""

    def _reversed(self):
        import collections

        from agnes_tpu_torch.serve.queue import _Chunk

        return collections.deque(
            _Chunk(tuple(col[::-1] for col in c.cols),
                   None if c.dig is None else c.dig[::-1], c.ts)
            for c in reversed(self._chunks))

    def _pop(self, n, count_drained=True):
        self._chunks = self._reversed()
        out = super()._pop(n, count_drained)
        self._chunks = self._reversed()
        return out


class _UnchunkedSystem(AdmissionSystem):
    """Doctored: preverified builds are NOT chunked — a cache-hit
    burst spanning 3+ (round, class) groups dispatches P >= 4, an
    unwarmed shape (live compile stall in production)."""

    preverified_chunk = 99


class _TaintSplitSystem(AdmissionSystem):
    """Doctored: when ANY pending row is a cache hit, the whole batch
    rides the unsigned build — fresh rows skip verification."""

    def _split(self, rows):
        if self.cache is not None and any(r.verified for r in rows):
            return list(rows), []
        return super()._split(rows)


class _LossySystem(AdmissionSystem):
    queue_cls = _LossyDrainQueue


class _LifoSystem(AdmissionSystem):
    queue_cls = _LifoDrainQueue


def _lossy_fold_table_cls():
    """Doctored BlsClassTable built lazily (serve/bls_lane.py stays off
    the module's import path, as in AdmissionSystem): once a class
    holds two shares, fold() silently drops the highest-validator one
    — counters untouched, the classic lost-update under the leaf
    mutex.  Caught by the class-bucket conservation monitor."""
    from agnes_tpu_torch.serve.bls_lane import BlsClassTable

    class _LossyFoldTable(BlsClassTable):
        def fold(self, wire_bytes, decode: bool = True) -> dict:
            res = super().fold(wire_bytes, decode)
            if res["folded"]:
                with self._mu:
                    for cls in self.classes.values():
                        if cls.n_signers >= 2:
                            v = max(cls.shares)
                            del cls.shares[v]
                            cls.signers[v] = False
                            cls.weight -= int(self.registry.powers[v])
                            break
            return res

    return _LossyFoldTable


class _LossyBlsFoldSystem(AdmissionSystem):
    @property
    def bls_table_cls(self):
        return _lossy_fold_table_cls()


class _PairingBlindSystem(AdmissionSystem):
    """Doctored: skips the per-class pairing verdict — forged shares
    ride the single aggregate lane with the class's combined weight.
    Caught by the aggregate-purity edge monitor."""

    bls_pairing_blind = True


#: mutant name -> (system class, property caught by, config)
ADMISSION_MUTANTS: Dict[str, tuple] = {
    "lose_drained_record": (
        _LossySystem, "conservation",
        AdmissionMCConfig(name="mut_lossy", depth=4, max_copies=2,
                          target=2)),
    "starve_oldest_record": (
        _LifoSystem, "starvation",
        # DISTINCT templates (max_copies=1) make every record
        # identifiable, so the fungible-copy FIFO-optimal age
        # assumption (AdmissionSystem._pump) cannot mask the
        # reordering.  capacity/target = 3 < starve_bound = 4, so an
        # HONEST FIFO drain can never violate — only the newest-first
        # mutant can, by draining each freshly-submitted flooder while
        # the first-admitted victim's age climbs past the bound
        AdmissionMCConfig(name="mut_lifo", depth=13, target=1,
                          capacity=3, max_copies=1, starve_bound=4,
                          templates=((1, 6, 0, 0), (0, 0, 0, 0),
                                     (0, 1, 0, 0), (0, 2, 0, 0),
                                     (0, 3, 0, 0), (0, 4, 0, 0),
                                     (0, 5, 0, 0)))),
    "unchunked_preverified_build": (
        _UnchunkedSystem, "pbound",
        AdmissionMCConfig(name="mut_unchunked", depth=13, target=4,
                          max_rung=8, max_copies=2,
                          templates=((0, 0, 0, 0), (0, 1, 0, 1),
                                     (0, 2, 1, 0)))),
    "taint_split_fresh_rides_unsigned": (
        _TaintSplitSystem, "purity",
        AdmissionMCConfig(name="mut_taint", depth=8, target=2,
                          max_copies=2,
                          templates=((0, 0, 0, 0), (1, 1, 0, 0)))),
    # a fold that loses a share out of an open class bucket
    # without counting it anywhere — caught by the class-bucket
    # conservation monitor (folded == open + agg + fallback + dropped)
    "lossy_bls_fold": (
        _LossyBlsFoldSystem, "conservation",
        AdmissionMCConfig(name="mut_bls_lossy", depth=5, max_copies=1,
                          templates=((0, 0, 0, 0),), bls=True,
                          bls_templates=((0, 0, 0), (0, 1, 0),
                                         (0, 2, 0)),
                          bls_target=3)),
    # a close that "clears" a class without the pairing —
    # forged shares folded into the one aggregate lane (purity)
    "pairing_blind_aggregate": (
        _PairingBlindSystem, "purity",
        AdmissionMCConfig(name="mut_bls_blind", depth=4, max_copies=1,
                          templates=((0, 0, 0, 0),), bls=True,
                          bls_templates=((0, 0, 0), (0, 1, 0)),
                          bls_target=2, bls_forged=(1,))),
}


def self_test_admission() -> dict:
    """Each doctored stage must be caught, its counterexample must
    ddmin-minimize, and the minimized schedule must run CLEAN on the
    honest model (the violation is the mutation's, not the model's)."""
    out = {}
    for name, (sys_cls, prop, cfg) in ADMISSION_MUTANTS.items():
        rep = explore_admission(cfg, system_cls=sys_cls)
        caught = [c for c in rep.violations
                  if c.violation.property == prop]
        assert caught, (
            f"admission mutant {name}: no {prop} violation in "
            f"{rep.states} states")
        ce = caught[0]
        ce.minimized = minimize_admission(cfg, ce.schedule, prop,
                                          system_cls=sys_cls)
        assert admission_reproduces(cfg, ce.minimized, prop,
                                    system_cls=sys_cls)
        _, honest = run_admission_with_monitors(cfg, ce.minimized)
        assert not honest, (
            f"admission mutant {name}: minimized schedule also "
            f"violates on the honest model: {honest}")
        out[name] = {
            "property": prop,
            "states_to_detection": rep.states,
            "schedule_len": len(ce.schedule),
            "minimized_len": len(ce.minimized),
            "counterexample": ce.to_json(),
        }
    return out


# ---------------------------------------------------------------------------
# Corpus emission (tests/corpus/admission/*.json)
# ---------------------------------------------------------------------------

#: hand-written milestone schedules (deterministic coverage witnesses
#: the serve-plane replay test drives through the REAL pipeline):
#: name -> (config, schedule, post-condition on the honest model)
ADMISSION_MILESTONES: Dict[str, tuple] = {}


def _register_milestones() -> None:
    cfg = ADMISSION_SMOKE[0]
    ADMISSION_MILESTONES["adm_dedup_roundtrip"] = (
        cfg,
        # fresh dispatch -> settle caches digests -> identical bytes
        # re-admit pre-verified -> unsigned (verify-free) dispatch
        [("s", 0), ("s", 1), ("b",), ("v",),
         ("s", 0), ("s", 1), ("b",)],
        lambda s: any(not signed
                      for _p, signed, _c, _r in s.dispatch_log))
    ADMISSION_MILESTONES["adm_held_window_flush"] = (
        cfg,
        # a future-round record holds through a pump, re-enters on the
        # window advance, and dispatches on the next tick
        [("s", 3), ("b",), ("w",), ("b",)],
        lambda s: s.dispatched[3] == 1)
# (called at module bottom — the milestone configs live in the scope
# tables defined below)


def emit_admission_corpus(directory: str,
                          include_mutants: bool = True) -> List[str]:
    """(Re)generate the admission regression corpus: the milestone
    schedules plus each admission mutant's minimized counterexample
    (stamped with the HONEST model's outcome — clean, like the
    consensus mutant corpus).  Deterministic."""
    import json
    import os

    os.makedirs(directory, exist_ok=True)
    written = []
    for name, (cfg, sched, check) in ADMISSION_MILESTONES.items():
        sys_, viols = run_admission_with_monitors(cfg, sched)
        assert not viols, (name, viols)
        assert check(sys_), f"milestone {name} post-condition failed"
        entry = admission_corpus_entry(
            name, cfg, sched, origin="hand-written milestone")
        path = os.path.join(directory, f"{name}.json")
        with open(path, "w") as f:
            json.dump(entry, f, indent=1, sort_keys=True)
            f.write("\n")
        written.append(path)
    if include_mutants:
        for mname, r in self_test_admission().items():
            ce = r["counterexample"]
            cfg = AdmissionMCConfig.from_json(ce["config"])
            acts = [AdmissionSystem.action_from_json(a)
                    for a in ce["schedule"]]
            entry = admission_corpus_entry(
                f"adm_mut_{mname}", cfg, acts,
                origin=f"minimized {mname} admission-mutant "
                       f"counterexample (honest replay: clean)")
            path = os.path.join(directory, f"adm_mut_{mname}.json")
            with open(path, "w") as f:
                json.dump(entry, f, indent=1, sort_keys=True)
                f.write("\n")
            written.append(path)
    return written


# ---------------------------------------------------------------------------
# Scopes (aggregated into the modelcheck CLI by run_scope)
# ---------------------------------------------------------------------------

ADMISSION_TINY: Tuple[AdmissionMCConfig, ...] = (
    AdmissionMCConfig(name="adm_tiny", depth=8, max_copies=2,
                      templates=((0, 0, 0, 0), (1, 1, 0, 0),
                                 (1, 2, 1, 0))),
)

#: the twin's CI envelope: ~210k distinct states, ~90s
#: sequential (dedup_window ~143k/60s is the flagship; the other two
#: shards are ~30-37k each)
ADMISSION_SMOKE: Tuple[AdmissionMCConfig, ...] = (
    # the full alphabet: both instances, both vote classes, a held
    # future-round template, dedup on — fairness + split + window
    AdmissionMCConfig(name="adm_dedup_window", depth=9),
    # dedup OFF + drop_oldest under a tight capacity: the overload
    # policies' conservation story without the cache in the state
    AdmissionMCConfig(name="adm_drop_oldest", depth=14, dedup=False,
                      capacity=4, policy="drop_oldest", max_copies=3,
                      templates=((0, 0, 0, 0), (0, 1, 0, 1),
                                 (1, 2, 0, 0))),
    # fairness cap pressure: one instance may hold at most 2 slots,
    # the other instance's records must still flow (starvation)
    AdmissionMCConfig(name="adm_fairness_cap", depth=10, capacity=4,
                      instance_cap=2, max_copies=2,
                      templates=((0, 0, 0, 0), (0, 1, 0, 0),
                                 (1, 2, 0, 0))),
    # BLS class buckets beside the record queue — both vote
    # classes fold, validator 2's shares fail the (modeled) pairing so
    # the prevote class exercises the per-share fallback split, and
    # validator 3 has no proof of possession (folds rejected, counted)
    AdmissionMCConfig(name="adm_bls_classes", depth=10, max_copies=2,
                      templates=((0, 0, 0, 0),), bls=True,
                      bls_templates=((0, 0, 0), (0, 1, 0), (0, 2, 0),
                                     (0, 1, 1), (0, 3, 1)),
                      bls_target=3, bls_max_classes=2,
                      bls_forged=(2,), bls_no_pop=(3,)),
)

ADMISSION_SCOPES = {"tiny": ADMISSION_TINY, "smoke": ADMISSION_SMOKE,
                    "full": ADMISSION_SMOKE}

_register_milestones()
