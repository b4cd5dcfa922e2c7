"""Argument checks and dispatch shared by the kernel wrappers.

Every wrapper takes flat, contiguous int32 tensors on one device, runs its
plain torch version when they lie on the CPU, launches its kernel when they
lie on a CUDA device, and raises on any other device; nothing falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ..constants import LANES, OV_ROWS

OV = OV_ROWS * LANES


def int32_vectors(fn: str, **tensors: torch.Tensor) -> torch.device:
    """Check that every tensor is a contiguous 1-D int32 tensor and that all
    lie on one device; return that device."""
    if not all(isinstance(x, torch.Tensor) for x in tensors.values()):
        raise TypeError(f"{fn} takes torch tensors")
    if len({x.device for x in tensors.values()}) != 1:
        raise ValueError(f"{fn}: tensors on different devices")
    for name, x in tensors.items():
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous 1-D int32 "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
    return next(iter(tensors.values())).device


def n_tiles(fn: str, keys: torch.Tensor, tile: int, *,
            min_tile: int = OV + 1) -> int:
    """The tile count of ``keys`` (tile a power of two >= min_tile that
    divides its length)."""
    if tile < min_tile or tile & (tile - 1):
        raise ValueError(f"{fn}: tile must be a power of two >= {min_tile}, "
                         f"got {tile}")
    if keys.numel() % tile:
        raise ValueError(f"{fn}: {keys.numel()} keys are not a multiple of "
                         f"tile={tile}")
    return keys.numel() // tile


def per_tile(fn: str, count: int, **tensors: torch.Tensor) -> None:
    for name, x in tensors.items():
        if x.numel() != count:
            raise ValueError(f"{fn}: {name} needs {count} entries, got "
                             f"{x.numel()}")


def runs_kernel(fn: str, device: torch.device) -> bool:
    """False for CPU tensors (the plain version runs), True for CUDA tensors
    on a machine with CUDA; raises otherwise."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{fn} runs on cpu or cuda tensors, not "
                         f"{device.type}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{fn} got CUDA tensors but CUDA is not available")
    return True


def kernel_tile(fn: str, tile: int, tiles: tuple) -> None:
    if tile not in tiles:
        raise ValueError(f"{fn}: the CUDA kernel takes tile in {tiles}, got "
                         f"{tile}")


def aligned(fn: str, **tensors: torch.Tensor) -> None:
    """The kernels load and store 16 bytes at a time."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be 16-byte aligned")


def ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's address for a launch, or None (a null pointer)."""
    return None if x is None else x.data_ptr()


def launch(fn: str, entry: str, device: torch.device, *args) -> None:
    """Call the library's ``entry`` with ``args`` and the current stream of
    ``device`` appended; raise if it returns a CUDA error."""
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, entry)(*args, stream)
    _build.check(code, f"{fn} launch")
