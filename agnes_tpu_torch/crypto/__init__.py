"""crypto layer of the PyTorch port (see the package docstring).

`host_sign` / `host_verify` are the port's one host signer and host
verifier (twin of `agnes_tpu.crypto.host_sign` / `host_verify`): the
C++ Ed25519 of `core/native.py`, built with g++ at first use.  There is
no fallback: a failed build raises.  RFC 8032 signatures are
deterministic, so they equal `crypto/ed25519_ref.py`'s (the tests'
oracle) byte for byte.

The package also offers the twin's names from `ed25519_ref` (the RFC
8032 oracle: `keypair`, `sign`, `verify`) and `encoding` (the canonical
signing bytes).  Both import no torch: the consensus checker reaches
this package through the host signer and must stay torch-free.
"""

from agnes_tpu_torch.crypto.ed25519_ref import (  # noqa: F401
    keypair,
    sign,
    verify,
)
from agnes_tpu_torch.crypto.encoding import (  # noqa: F401
    VOTE_MSG_LEN,
    proposal_signing_bytes,
    vote_signing_bytes,
)


def host_sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 signature of `msg` under the 32-byte `seed` (C++)."""
    from agnes_tpu_torch.core import native

    return native.sign(seed, msg)


def host_verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    """Cofactored RFC 8032 verification on the host (C++)."""
    from agnes_tpu_torch.core import native

    return native.verify(pk, msg, sig)

