"""analysis layer of the PyTorch port (see the package docstring).

The names below come from modules that import no torch (`findings.py`,
`retrace.py`): the consensus checker runs this package's `__init__` in
an interpreter that must stay torch-free.
"""

from agnes_tpu_torch.analysis.findings import Finding  # noqa: F401
from agnes_tpu_torch.analysis.retrace import (  # noqa: F401
    RetraceError,
    RetraceSentinel,
    signature,
)
