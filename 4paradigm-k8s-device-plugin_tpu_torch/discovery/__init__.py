"""Card discovery and health on an NVIDIA GPU node.

The port's counterpart of ``vtpu``'s discovery package (and of the
reference's NVML layer, nvidia.go:43-237), with these backends:

- ``fake``   — deterministic fake H100 inventories, first-class for tests.
- ``nvml``   — NVML through ctypes: UUID, memory, MIG instances, NVLink
               peers and PCIe distance, critical-XID events.
- ``procfs`` — ``/proc/driver/nvidia/gpus`` and sysfs, without the driver
               library.
"""

from .types import GpuChip, GpuTopology, Health, MigInstance  # noqa: F401
from .base import ChipBackend  # noqa: F401
from .factory import make_backend  # noqa: F401
