"""The serve plane of the PyTorch port (twin of `agnes_tpu.serve`): the
online path between a network front end and the device driver.

  queue.py      bounded admission over packed 96-byte wire records:
                reject-newest or drop-oldest backpressure, per-instance
                fairness caps, the dedup-cache lookup
  batcher.py    size-or-deadline micro-batching over a ShapeLadder, so a
                service launches a fixed, warmed set of shapes
  cache.py      the verified-vote dedup cache (SHA-256 of the wire
                record, inserted only after a clean verify on the card)
  pipeline.py   double-buffered densify/dispatch: the host densifies
                batch k+1 while the card runs the fused signed step of
                batch k
  service.py    the façade: submit / pump / poll_decisions / drain, with
                metrics, spans and the flight recorder
  bls_lane.py   the BLS aggregate lane: one pairing per vote class
  native_admission.py
                the C++ admission queue and its shards (one GIL-releasing
                call a submit and a drain), whose drain also densifies
                eligible batches straight into the signed step's arrays
  threaded.py   ThreadedVoteService: submit and dispatch threads over a
                VoteService, the caller's submit wait-free

Waiting for a later slice: mesh serving (ROADMAP §1 item 5).
"""

from agnes_tpu_torch.serve.batcher import MicroBatcher, ShapeLadder  # noqa: F401
from agnes_tpu_torch.serve.bls_lane import (  # noqa: F401
    BlsClassTable,
    BlsKeyRegistry,
    BlsLane,
)
from agnes_tpu_torch.serve.cache import VerifiedCache  # noqa: F401
from agnes_tpu_torch.serve.native_admission import (  # noqa: F401
    NativeAdmissionQueue,
    NativeAdmissionShards,
)
from agnes_tpu_torch.serve.pipeline import ServePipeline  # noqa: F401
from agnes_tpu_torch.serve.queue import (  # noqa: F401
    DROP_OLDEST,
    REJECT_NEWEST,
    AdmissionQueue,
    AdmitResult,
    Inbox,
    NativePhases,
    WireColumns,
)
from agnes_tpu_torch.serve.service import Decision, VoteService  # noqa: F401
from agnes_tpu_torch.serve.threaded import (  # noqa: F401
    ThreadedVoteService,
    threaded_service,
)
