"""bridge layer of the PyTorch port (see the package docstring):
`ingest.VoteBatcher` (numpy densify), `native_ingest.NativeIngestLoop`
(the C++ ingest loop) and the wire codec, `evidence` (the slashing
join) and `value_table`."""

from agnes_tpu_torch.bridge.native_ingest import (  # noqa: F401
    NativeIngestLoop,
    pack_wire_votes,
)
