"""Key arrays of the port: flat, contiguous int32 tensors.

The JAX package keeps tiled relations as ``(rows, 128)`` arrays (``r2d``,
``s2d``); the port keeps the same bytes flat.  These helpers carry a JAX
package state (as numpy) across, so that a test can feed the port exactly
the bytes the JAX kernels saw.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import LANES


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
