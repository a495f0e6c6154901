"""Multi-device search of the port (keyhuntm1cpu_tpu/parallel):

- ``partition``: deterministic window-aligned range partitioning;
- ``mesh``: BSGS with the range (``ShardedBSGSEngine``) or the baby table
  (``ShardedTableBSGSEngine``, all_gather or ring) sharded over a list of
  devices, every visible card by default;
- ``brute_mesh``: the brute modes' fused chunk on a slice a device.

One process drives every device of its list; dist/multihost.py runs one
such process a host.
"""

from .partition import RangePartitioner, RangeSlice  # noqa: F401
from .mesh import (ShardedBSGSEngine, ShardedTableBSGSEngine, default_devices,  # noqa: F401
                   resolve_devices)
from .brute_mesh import ShardedBruteEngine  # noqa: F401
