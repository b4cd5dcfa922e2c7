"""Device mesh construction (counterpart of
``htm_hashjoin_tpu/parallel/mesh.py``).

The reference's parallel substrate is pinned pthreads + NUMA first-touch
(mc/src/cpu_mapping.c:54-81, generator.c:353-405).  Here a mesh is an
array of shards, each placed on a torch device, in the shape of the
requested mesh; the device-mapping file (the ``cpu-mapping.txt`` analog)
fixes the placement order.  An id that names no device wraps to
``id % len(devices)``, as the reference's ``get_cpu_id`` round robin does,
so a mapping may place several shards on one device: ``8 0 1 2 3 4 5 6 7``
puts eight shards on one card, or on the one CPU device.  Shards that
share a device run one after another.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import entry_device

#: the cpu-mapping.txt analog (mc/src/cpu_mapping.c:54-81, documented in
#: mc/src/cpu-mapping.txt.README): an optional file whose first number is a
#: count followed by that many device ids, fixing mesh placement order.
#: Looked up in $HTM_DEVICE_MAPPING, else ./device-mapping.txt.
MAPPING_ENV = "HTM_DEVICE_MAPPING"
MAPPING_FILE = "device-mapping.txt"


def load_device_mapping(path: Optional[str] = None) -> Optional[List[int]]:
    """Parse the mapping file (format: ``N id0 id1 ... idN-1`` over any
    whitespace — exactly cpu-mapping.txt's).  Returns None when no file is
    configured; raises on a malformed one (the reference silently falls back,
    but a typo silently changing placement is worth surfacing)."""
    path = path or os.environ.get(MAPPING_ENV) or (
        MAPPING_FILE if os.path.exists(MAPPING_FILE) else None)
    if path is None:
        return None
    with open(path) as f:
        nums = [int(t) for t in f.read().split()]
    if not nums or len(nums) < 1 + nums[0]:
        raise ValueError(f"malformed device mapping {path!r}: "
                         f"expected count then that many ids")
    return nums[1:1 + nums[0]]


@contextlib.contextmanager
def mapping_env(path: Optional[str]) -> Iterator[None]:
    """$HTM_DEVICE_MAPPING names ``path`` (None: unset) inside the block
    only; the variable is restored after it."""
    old = os.environ.get(MAPPING_ENV)
    try:
        if path is None:
            os.environ.pop(MAPPING_ENV, None)
        else:
            os.environ[MAPPING_ENV] = path
        yield
    finally:
        if old is None:
            os.environ.pop(MAPPING_ENV, None)
        else:
            os.environ[MAPPING_ENV] = old


def _devices(device: torch.device) -> List[torch.device]:
    """The devices of ``device``'s kind, by id: every visible card, or the
    one CPU device (id 0)."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device.type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"a mesh is made of cpu or cuda devices, not {device}")


def _ordered_devices(mapping: Optional[List[int]],
                     device: torch.device) -> List[torch.device]:
    """Devices in mapping order (by device id), round-robin wrapped like
    get_cpu_id (cpu_mapping.c:54-81); default order otherwise."""
    devices = _devices(torch.device(device))
    if not mapping:
        return devices
    return [devices[i % len(devices)] for i in mapping]


class Mesh:
    """Shards in a mesh shape: ``devices`` is a numpy object array of
    ``torch.device`` in that shape (shard ``d`` is ``devices.flat[d]``,
    row-major, so on a ``(H, C)`` mesh ``d = h*C + c``), with one name per
    axis."""

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-D mesh")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def ndim(self) -> int:
        return int(self.devices.ndim)

    @property
    def shard_devices(self) -> List[torch.device]:
        """Each shard's device, by shard index."""
        return list(self.devices.flat)


def make_mesh(shape: Tuple[int, ...] = (), axis_names: Sequence[str] = ("x",),
              mapping: Optional[List[int]] = None, device=None) -> Mesh:
    """Build a mesh of the requested shape over devices of ``device``'s
    kind (the card unless the caller passes the CPU); () means all
    available devices on one axis.  Placement order honors the
    device-mapping file when one is configured."""
    dev = entry_device(device, "the distributed join")
    devices = _ordered_devices(mapping if mapping is not None
                               else load_device_mapping(), dev)
    if not shape:
        shape = (len(devices),)
    n = math.prod(shape)
    if n > len(devices):
        raise ValueError(f"mesh {shape} needs {n} devices, "
                         f"have {len(devices)}")
    return Mesh(np.asarray(devices[:n], dtype=object).reshape(shape),
                axis_names[: len(shape)])


def shard_relation(keys: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Contiguous row blocks of ``keys``, one a shard, each on its shard's
    device (the analog of the reference's static per-thread chunking,
    mc/src/no_partitioning_join.c:563-593).  A block that already lies on
    its device is a view."""
    if keys.numel() % mesh.size:
        raise ValueError(f"{keys.numel()} rows do not split into "
                         f"{mesh.size} equal shards")
    return [block.to(dev) for block, dev in
            zip(keys.reshape(mesh.size, -1), mesh.shard_devices)]
