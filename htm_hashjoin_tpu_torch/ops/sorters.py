"""Plain torch forms of the per-tile sorters of the banded join.

Each works on an ``(F, T)`` view (one row per tile, T a power of two) and
returns a new tensor.  They are the references the CUDA kernel is held to,
and they equal the JAX package's in-kernel networks
(``htm_hashjoin_tpu/ops/pallas/linops.py``) element for element, including
on input whose displacement exceeds the window (the output is then
unsorted, and the caller's inversion count sees it).
"""

from __future__ import annotations

import torch


def block_size(window: int, tile: int) -> int:
    """The shifted-block sorter's block: the next power of two >= 2*window,
    capped at the tile."""
    b = 1
    while b < 2 * window:
        b *= 2
    return min(b, tile)


def bitonic_sort_tiles(v: torch.Tensor) -> torch.Tensor:
    """Full ascending sort of every tile (``linops.bitonic_sort_keys``)."""
    return torch.sort(v, dim=1).values


def bitonic_alt_sort_tiles(v: torch.Tensor) -> torch.Tensor:
    """Full sort of every tile, ascending on even tiles and descending on odd
    ones (``linops.bitonic_sort_keys`` with ``final_asc`` = tile parity: the
    global sort's phase A, which leaves every tile pair bitonic)."""
    v = torch.sort(v, dim=1).values
    return torch.where((torch.arange(v.shape[0], device=v.device) % 2 == 1)
                       [:, None], v.flip(1), v)


def shifted_block_sort_tiles(v: torch.Tensor, window: int) -> torch.Tensor:
    """Bounded-displacement sorter (``linops.shifted_block_sort_keys``):
    sort every aligned b-block, then every b-block of the half-shifted grid
    covering ``[b/2, T - b/2)``; the two end half-blocks stay as they are.
    Exact when no key sits more than ``window`` places from its sorted
    position."""
    f, t = v.shape
    b = block_size(window, t)
    v = torch.sort(v.reshape(f, t // b, b), dim=2).values.reshape(f, t)
    if b >= t:
        return v
    h = b // 2
    mid = torch.sort(v[:, h:t - h].reshape(f, t // b - 1, b),
                     dim=2).values.reshape(f, t - b)
    return torch.cat([v[:, :h], mid, v[:, t - h:]], dim=1)


def odd_even_passes_tiles(v: torch.Tensor, passes: int) -> torch.Tensor:
    """``passes`` rounds of odd-even transposition
    (``linops.odd_even_passes_keys``): an even phase on pairs (2j, 2j+1),
    then an odd phase on pairs (2j+1, 2j+2) with both ends unpaired."""
    f, t = v.shape
    for _ in range(passes):
        pairs = v.reshape(f, t // 2, 2)
        v = torch.stack([pairs.amin(2), pairs.amax(2)], 2).reshape(f, t)
        inner = v[:, 1:t - 1].reshape(f, t // 2 - 1, 2)
        v = torch.cat([v[:, :1],
                       torch.stack([inner.amin(2), inner.amax(2)],
                                   2).reshape(f, t - 2),
                       v[:, t - 1:]], dim=1)
    return v


# The kernels' method codes (csrc/banded_common.cuh: Method).
METHODS = {"bitonic": 0, "blocks": 1, "oddeven": 2, "bitonic_alt": 3}


def sort_tiles(v: torch.Tensor, method: str, passes: int) -> torch.Tensor:
    """Dispatch on the kernels' ``method`` names."""
    if method == "bitonic":
        return bitonic_sort_tiles(v)
    if method == "bitonic_alt":
        return bitonic_alt_sort_tiles(v)
    if method == "blocks":
        return shifted_block_sort_tiles(v, passes)
    if method == "oddeven":
        return odd_even_passes_tiles(v, passes)
    raise ValueError(f"unknown sort method {method!r}")
