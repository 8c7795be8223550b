"""The shape ladder's BLS rungs (the part of `agnes_tpu.serve.batcher`
that the BLS aggregate lane needs).

The lane pads each vote class's signer count onto a BLS rung before the
`bls_aggregate` MSMs, and the class count of a pairing call onto a class
rung.  Nothing here compiles per shape, so the rungs bound the set of
shapes a service runs rather than a compile cache; the twin's lane-count
rungs (`ShapeLadder.plan`) wait for the serve plane.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _ceil_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class ShapeLadder:
    """Ascending power-of-two shapes the serve plane may emit: signer
    counts of one class (`bls_rungs`) and classes of one pairing call
    (`bls_class_rungs`).  Empty = no BLS lane planned."""

    bls_rungs: Tuple[int, ...] = ()
    bls_class_rungs: Tuple[int, ...] = ()

    def with_bls(self, n_validators: int, min_rung: int = 16,
                 class_rungs: Tuple[int, ...] = (1, 4)) -> "ShapeLadder":
        """Extend with BLS aggregation rungs (powers of two from
        `min_rung` up to the validator count: a class never holds more
        signers than validators) and the pairing class rungs (one small
        and one burst shape; closes above the top rung chunk)."""
        min_rung = _ceil_pow2(min_rung)
        top = max(_ceil_pow2(n_validators), min_rung)
        rungs = []
        r = min_rung
        while r <= top:
            rungs.append(r)
            r <<= 1
        return dataclasses.replace(
            self, bls_rungs=tuple(rungs),
            bls_class_rungs=tuple(sorted(set(class_rungs))))

    def bls_rung_for(self, n_signers: int) -> int:
        """Smallest BLS rung holding `n_signers` aggregation lanes."""
        for r in self.bls_rungs:
            if n_signers <= r:
                return r
        raise ValueError(
            f"{n_signers} signers exceed the top BLS rung "
            f"{self.bls_rungs[-1] if self.bls_rungs else 0}")

    def bls_class_rung_for(self, n_classes: int) -> int:
        """Smallest pairing class rung holding `n_classes`; callers
        CHUNK above the top rung."""
        for r in self.bls_class_rungs:
            if n_classes <= r:
                return r
        if not self.bls_class_rungs:
            raise ValueError("no bls_class_rungs planned")
        return self.bls_class_rungs[-1]
