"""Key arrays of the port: flat, contiguous int32 tensors.

The JAX package keeps tiled relations as ``(rows, 128)`` arrays (``r2d``,
``s2d``); the port keeps the same bytes flat.  These helpers carry a JAX
package state (as numpy) across, so that a test can feed the port exactly
the bytes the JAX kernels saw, or probe the build artifact JAX made.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import LANES
from .joins.banded_backend import BandedBuild


def keys_from_numpy(arr, device=None) -> torch.Tensor:
    """A 1-D int32 tensor on ``device`` holding ``arr``'s values."""
    a = np.asarray(arr)
    if a.ndim != 1:
        raise ValueError(f"expected a 1-D key array, got shape {a.shape}")
    if not np.array_equal(a, a.astype(np.int32)):
        raise ValueError("keys do not fit in int32")
    return torch.from_numpy(np.array(a, np.int32)).to(device)   # a copy


def tiles_from_numpy(arr2d, device=None) -> torch.Tensor:
    """The flat int32 tensor of a tiled ``(rows, 128)`` array (row-major, so
    ``out.view(-1, 128)`` gives the rows back)."""
    a = np.asarray(arr2d)
    if a.ndim != 2 or a.shape[1] != LANES:
        raise ValueError(f"expected a (rows, {LANES}) array, got shape {a.shape}")
    return keys_from_numpy(a.reshape(-1), device)


def banded_build_from_numpy(build, device=None) -> BandedBuild:
    """The port's ``BandedBuild`` holding the same artifact as a JAX package
    ``BandedBuild`` (or any object with its fields: ``sorted2d``, ``mins``,
    ``maxs`` as arrays numpy can read, and ``tile``, ``n``, ``violations``,
    ``resorted``)."""
    return BandedBuild(tiles_from_numpy(np.asarray(build.sorted2d), device),
                       keys_from_numpy(np.asarray(build.mins), device),
                       keys_from_numpy(np.asarray(build.maxs), device),
                       int(build.tile), int(build.n), int(build.violations),
                       bool(build.resorted))
