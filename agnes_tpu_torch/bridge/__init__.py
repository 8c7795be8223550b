"""bridge layer of the PyTorch port (see the package docstring):
`ingest.VoteBatcher` (numpy densify), `native_ingest.NativeIngestLoop`
(the C++ ingest loop) and the wire codec, `evidence` (the slashing
join) and `value_table`.

`ingest` and `evidence` build device tensors, so their names resolve on
first access (a module `__getattr__`), as the twin keeps them lazy."""

from agnes_tpu_torch.bridge.native_ingest import (  # noqa: F401
    NativeIngestLoop,
    pack_wire_votes,
)
from agnes_tpu_torch.bridge.value_table import (  # noqa: F401
    SlotMap,
    ValueTable,
)

#: lazily exported names -> their module
_LAZY = {
    "DeviceEvidence": "agnes_tpu_torch.bridge.evidence",
    "collect_device_evidence": "agnes_tpu_torch.bridge.evidence",
    "verify_evidence": "agnes_tpu_torch.bridge.evidence",
    "VoteBatcher": "agnes_tpu_torch.bridge.ingest",
    "WireVote": "agnes_tpu_torch.bridge.ingest",
}


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value
