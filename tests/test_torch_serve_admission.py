"""Port differential: the serve plane's admission side against the JAX
package's, fed the same bytes and the same clock.

The wire codec (bytes both ways, the truncated tail), the AdmissionQueue
(random, malformed and out-of-range records, a fairness-flooded instance,
overflow under both policies, a dedup cache attached: every AdmitResult,
the counters, every drained WireColumns and `mc_canonical`), the
VerifiedCache (lookups, LRU evictions, `prune_decided`), ShapeLadder.plan
and `rung_for` at shapes no budget binds, and the MicroBatcher's
size-or-deadline closes.  Host only (numpy); every comparison is exact.
"""

import numpy as np
import pytest

from agnes_tpu.bridge import native_ingest as jni
from agnes_tpu.serve import batcher as jb
from agnes_tpu.serve import cache as jc
from agnes_tpu.serve import queue as jq
from agnes_tpu_torch.bridge import native_ingest as tni
from agnes_tpu_torch.serve import batcher as tb
from agnes_tpu_torch.serve import cache as tc
from agnes_tpu_torch.serve import queue as tq

I, V = 6, 5
GIB = 1 << 30


def _cols(rng, n, bad=False):
    inst = rng.randint(0, I, n)
    if bad:                                  # out-of-range instances
        inst[rng.rand(n) < 0.2] = I + rng.randint(0, 1000)
    return (inst, rng.randint(0, V, n), rng.randint(0, 3, n),
            rng.randint(0, 6, n), rng.randint(0, 2, n),
            rng.randint(-2, 5, n),
            rng.randint(0, 256, (n, 64)).astype(np.uint8))


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


def test_wire_codec_matches_jax():
    rng = np.random.RandomState(1)
    cols = _cols(rng, 257)
    wire = tni.pack_wire_votes(*cols)
    assert wire == jni.pack_wire_votes(*cols)
    assert tni.REC_SIZE == jni.REC_SIZE == 96
    for tail in (b"", b"\x01\x02\x03"):
        for a, b in zip(tni.unpack_wire_votes(wire + tail),
                        jni.unpack_wire_votes(wire + tail)):
            np.testing.assert_array_equal(a, b)
    assert len(tni.unpack_wire_votes(wire[:95])[0]) == 0
    # no signatures: zero bytes in both
    assert tni.pack_wire_votes(*cols[:6]) == jni.pack_wire_votes(*cols[:6])


def _same_columns(t, j):
    assert (t is None) == (j is None)
    if t is None:
        return
    for f in ("instance", "validator", "height", "round_", "typ", "value",
              "signatures", "verified"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)
    assert (t.digest is None) == (j.digest is None)
    if t.digest is not None:
        np.testing.assert_array_equal(t.digest, j.digest)
    assert t.t_first == j.t_first and t.native_phases is None


@pytest.mark.parametrize("policy", [tq.REJECT_NEWEST, tq.DROP_OLDEST])
@pytest.mark.parametrize("cached", [False, True])
def test_queue_matches_jax(policy, cached):
    rng = np.random.RandomState(2 + cached)
    caches = ((tc.VerifiedCache(64 * tc.ENTRY_BYTES),
               jc.VerifiedCache(64 * jc.ENTRY_BYTES)) if cached
              else (None, None))
    tqu = tq.AdmissionQueue(I, 40, instance_cap=9, policy=policy,
                            cache=caches[0], clock=Clock())
    jqu = jq.AdmissionQueue(I, 40, instance_cap=9, policy=policy,
                            cache=caches[1], clock=Clock())
    inserted = []
    for step in range(30):
        k = step % 6
        if k == 0:
            wire = tni.pack_wire_votes(*_cols(rng, rng.randint(1, 30),
                                              bad=True))
        elif k == 1:                          # fairness flood
            c = list(_cols(rng, 25))
            c[0][:] = 2
            wire = tni.pack_wire_votes(*c)
        elif k == 2:                          # truncated tail
            wire = tni.pack_wire_votes(*_cols(rng, 7)) + b"\x07" * 13
        elif k == 3 and inserted:             # a re-delivery
            wire = inserted[-1]
        else:
            wire = tni.pack_wire_votes(*_cols(rng, rng.randint(0, 15)))
        tr, jr = tqu.submit(wire), jqu.submit(wire)
        assert tuple(tr) == tuple(jr) and tr.rejected == jr.rejected
        if cached and step % 6 == 5:
            # a clean verify settles: the same records enter both caches
            dig = tq._record_digests(wire, np.arange(len(wire) // 96))
            np.testing.assert_array_equal(
                dig, jq._record_digests(wire, np.arange(len(wire) // 96)))
            hts = np.arange(len(dig)) % 3
            assert caches[0].insert(dig, np.zeros(len(dig)), hts) \
                == caches[1].insert(dig, np.zeros(len(dig)), hts)
            inserted.append(wire)
        if step % 3 == 2:
            n = rng.randint(-1, 20)
            _same_columns(tqu.drain(n), jqu.drain(n))
        assert tqu.mc_canonical() == jqu.mc_canonical()
        assert tqu.oldest_ts == jqu.oldest_ts
        assert [tqu.instance_depth(i) for i in range(I)] == \
            [jqu.instance_depth(i) for i in range(I)]
    assert tqu.counters == jqu.counters
    assert tqu.counters["rejected_fairness"] > 0
    assert tqu.counters["rejected_malformed"] > 0
    assert (tqu.counters["rejected_overflow"] + tqu.counters["evicted"]) > 0
    if cached:
        assert caches[0].counters == caches[1].counters
        assert caches[0].counters["hits"] > 0
    _same_columns(tqu.drain(), jqu.drain())
    assert tqu.mc_clone().mc_canonical() == jqu.mc_clone().mc_canonical()


def test_verified_cache_matches_jax():
    rng = np.random.RandomState(4)
    t, j = (tc.VerifiedCache(32 * tc.ENTRY_BYTES),
            jc.VerifiedCache(32 * jc.ENTRY_BYTES))
    pool = rng.randint(0, 256, (60, 32)).astype(np.uint8)
    for step in range(40):
        idx = rng.randint(0, 60, rng.randint(1, 12))
        if step % 2:
            np.testing.assert_array_equal(t.lookup(pool[idx]),
                                          j.lookup(pool[idx]))
        else:
            inst, hts = rng.randint(0, I, len(idx)), rng.randint(0, 4,
                                                                 len(idx))
            assert t.insert(pool[idx], inst, hts) == \
                j.insert(pool[idx], inst, hts)
        if step % 7 == 6:
            h = rng.randint(0, 4, I)
            assert t.prune_decided(h) == j.prune_decided(h)
        assert t.mc_canonical() == j.mc_canonical()
    assert t.snapshot() == j.snapshot()
    assert t.counters["evicted"] > 0 and t.counters["pruned_height"] > 0
    for who in (t, j):
        who.note_rejected_batch()
        who.note_unverified_batch()
    assert t.counters == j.counters and t.hit_rate == j.hit_rate


@pytest.mark.parametrize("shape", [(3, 4, None, 16), (10, 100, None, 256),
                                   (64, 1000, 30000, 256),
                                   (1024, 1000, None, 256)])
def test_ladder_matches_jax(shape):
    """At 80 GiB no rung of these shapes is refused by either budget."""
    n_i, n_v, cap, lo = shape
    t = tb.ShapeLadder.plan(n_i, n_v, max_votes=cap, min_rung=lo,
                            hbm_bytes=80 * GIB)
    j = jb.ShapeLadder.plan(n_i, n_v, max_votes=cap, min_rung=lo,
                            hbm_bytes=80 * GIB)
    assert t.rungs == j.rungs
    assert t.min_rung == j.min_rung and t.max_rung == j.max_rung
    for n in (1, lo - 1, lo, lo + 1, t.max_rung // 2 + 1, t.max_rung):
        assert t.rung_for(n) == j.rung_for(n)
    with pytest.raises(ValueError):
        t.rung_for(t.max_rung + 1)
    tw, jw = t.with_bls(n_v), j.with_bls(n_v)
    assert (tw.bls_rungs, tw.bls_class_rungs) == (jw.bls_rungs,
                                                  jw.bls_class_rungs)
    assert tw.describe() == jw.describe()


def test_micro_batcher_matches_jax():
    rng = np.random.RandomState(5)
    out = []
    for q_mod, b_mod, ladder in ((tq, tb, tb.ShapeLadder.plan(
            I, V, min_rung=8, hbm_bytes=GIB)), (jq, jb, jb.ShapeLadder.plan(
                I, V, min_rung=8, hbm_bytes=GIB))):
        rng = np.random.RandomState(5)
        clock = Clock()
        q = q_mod.AdmissionQueue(I, 200, clock=clock)
        mb = b_mod.MicroBatcher(q, ladder, target_votes=24,
                                max_delay_s=2.0, clock=clock)
        closes = []
        for _ in range(40):
            q.submit(tni.pack_wire_votes(*_cols(rng, rng.randint(0, 13))))
            b = mb.poll()
            closes.append(None if b is None else
                          (len(b), b.t_first, b.instance.tolist(),
                           mb.fill(len(b))))
        b = mb.flush()
        closes.append(None if b is None else len(b))
        out.append((closes, mb.batches_closed, mb.closed_by_size,
                    mb.closed_by_deadline))
    assert out[0] == out[1]
    assert out[0][2] > 0 and out[0][3] > 0


def test_inbox_matches_jax():
    boxes = (tq.Inbox(capacity=3), jq.Inbox(capacity=3))
    for box in boxes:
        with pytest.raises(ValueError):
            type(box)(capacity=0)
    for blob in (b"a", b"b", b"c", b"d"):
        assert boxes[0].put(blob) == boxes[1].put(blob)
    assert [b.get(timeout=0) for b in boxes] == [b"a", b"a"]
    for box in boxes:
        box.close()
    assert [b.put(b"e") for b in boxes] == [False, False]
    out = [[b.get(), b.get(), b.get()] for b in boxes]
    assert out[0] == out[1] == [b"b", b"c", None]
    assert [(b.enqueued, b.dropped, b.depth) for b in boxes] == \
        [(3, 2, 0)] * 2
