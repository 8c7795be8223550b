"""device layer of the PyTorch port (see the package docstring)."""

from agnes_tpu_torch.device.encoding import (  # noqa: F401
    DeviceEvent,
    DeviceMessage,
    DeviceState,
)
from agnes_tpu_torch.device.state_machine import (  # noqa: F401
    apply_batch,
    apply_scalar,
)
