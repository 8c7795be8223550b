"""The typed run configuration (twin of `agnes_tpu.utils.config`).

The one place a deployment describes itself: scale (validators,
instances), the tally window, the mesh shape, the timeouts and the
dtype policy.  `make_batcher` and `make_native_loop` build the ingestion
bridge the configuration governs (so `verify_mode` and `held_cap`
actually apply), on the card unless a `device=` keyword says otherwise;
`from_args` gives every driver CLI the same flags.
"""

from __future__ import annotations

import argparse
from dataclasses import asdict, dataclass, field
from typing import Optional, Tuple

from agnes_tpu_torch.core.executor import TimeoutConfig


@dataclass(frozen=True)
class RunConfig:
    # scale
    n_validators: int = 1000
    n_instances: int = 10_000
    # tally / proposer window (rounds tracked on the device)
    n_rounds: int = 4
    n_slots: int = 4
    # mesh: (data / instances axis, validator axis); None = one device
    mesh: Optional[Tuple[int, int]] = None
    # timeouts (virtual units)
    timeouts: TimeoutConfig = field(default_factory=TimeoutConfig)
    # dtype policy: tally weights stay int32; this names the dtype of
    # any floating-point surface
    float_dtype: str = "bfloat16"
    # signature verification of the ingestion bridge: "lanes" = the
    # per-lane kernel; "msm" = the batch random-linear-combination path
    # with per-lane fallback (both cofactored, identical verdicts: a
    # throughput choice; crypto/msm.py)
    verify_mode: str = "lanes"
    # bound on the bridge's pre-verification future-round hold-back
    # (None = two full [instances, validators] ticks, at least 65,536)
    held_cap: Optional[int] = None
    # checkpointing
    checkpoint_dir: Optional[str] = None
    checkpoint_every_steps: int = 0     # 0 = disabled

    def validate(self) -> "RunConfig":
        assert self.n_validators >= 1 and self.n_instances >= 1
        assert self.n_rounds >= 1 and self.n_slots >= 1
        if self.mesh is not None:
            d, v = self.mesh
            assert self.n_instances % d == 0, "instances % mesh data axis"
            assert self.n_validators % v == 0, "validators % mesh val axis"
        assert self.float_dtype in ("bfloat16", "float32")
        assert self.verify_mode in ("lanes", "msm")
        assert self.held_cap is None or self.held_cap > 0
        return self

    def as_dict(self) -> dict:
        return asdict(self)

    # -- bridge factories: the way a deployment's ingestion bridge is
    # built, so verify_mode and held_cap govern the run ----------------------

    def make_batcher(self, **kw):
        """VoteBatcher sized and policied by this config (keywords
        override and go to the constructor, `device=` among them)."""
        from agnes_tpu_torch.bridge.ingest import VoteBatcher

        kw.setdefault("n_slots", self.n_slots)
        kw.setdefault("n_rounds", self.n_rounds)
        kw.setdefault("held_cap", self.held_cap)
        kw.setdefault("verify_mode", self.verify_mode)
        return VoteBatcher(self.n_instances, self.n_validators, **kw)

    def make_native_loop(self, pubkeys=None, powers=None, **kw):
        """NativeIngestLoop (the C++ event loop) for this config.  Its
        verify stage is per-lane only, so a config declaring
        verify_mode="msm" must use make_batcher: failing loudly here
        beats silently misreporting the run."""
        if self.verify_mode != "lanes":
            raise ValueError(
                f"verify_mode={self.verify_mode!r} is not supported by "
                "the native ingest loop; use make_batcher()")
        from agnes_tpu_torch.bridge.native_ingest import NativeIngestLoop

        kw.setdefault("n_slots", self.n_slots)
        kw.setdefault("n_rounds", self.n_rounds)
        kw.setdefault("held_cap", self.held_cap)
        return NativeIngestLoop(self.n_instances, self.n_validators,
                                pubkeys=pubkeys, powers=powers, **kw)

    @classmethod
    def from_args(cls, argv=None) -> "RunConfig":
        p = argparse.ArgumentParser(description=__doc__)
        p.add_argument("--validators", type=int, default=cls.n_validators)
        p.add_argument("--instances", type=int, default=cls.n_instances)
        p.add_argument("--rounds", type=int, default=cls.n_rounds)
        p.add_argument("--slots", type=int, default=cls.n_slots)
        p.add_argument("--mesh", type=str, default=None,
                       help="DxV, e.g. 4x2")
        p.add_argument("--float-dtype", default=cls.float_dtype)
        p.add_argument("--verify-mode", default=cls.verify_mode,
                       choices=("lanes", "msm"))
        p.add_argument("--held-cap", type=int, default=None)
        p.add_argument("--checkpoint-dir", default=None)
        p.add_argument("--checkpoint-every", type=int, default=0)
        a = p.parse_args(argv)
        mesh = None
        if a.mesh:
            d, v = a.mesh.lower().split("x")
            mesh = (int(d), int(v))
        return cls(n_validators=a.validators, n_instances=a.instances,
                   n_rounds=a.rounds, n_slots=a.slots, mesh=mesh,
                   float_dtype=a.float_dtype,
                   verify_mode=a.verify_mode, held_cap=a.held_cap,
                   checkpoint_dir=a.checkpoint_dir,
                   checkpoint_every_steps=a.checkpoint_every).validate()
