"""K3: global ascending sort of a power-of-two count of tiles.

Counterpart of ``htm_hashjoin_tpu/ops/pallas/join_kernels.py:
global_sort_tiles``.  On CUDA tensors ``global_sort_tiles`` runs the
hand-written stable LSD radix sort (``csrc/radix_sort.cu`` through
``radix_sort.sort_keys``: one histogram launch and four scatter passes, one
count in ``LAUNCHES`` a sort).  On CPU tensors it runs the plain version,
``torch.sort``; any other device raises, and nothing falls back.  Either
way ``SORTED_KEYS`` counts the keys it was given, padding included (the
join's line reports them per join as ``sortedKeys``).  The port
is held to the output only: the sorted keys, MAXI32 padding last.
"""

from __future__ import annotations

import torch

from . import _args, radix_sort

LAUNCHES = 0   # kernel sorts by global_sort_tiles (the plain path adds none)
SORTED_KEYS = 0   # keys given to global_sort_tiles, on either path


def global_sort_ref(keys: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the ascending sort of ``keys``."""
    return torch.sort(keys).values


def _check(keys, tile):
    dev = _args.int32_vectors("global_sort_tiles", keys=keys)
    n_tiles = _args.n_tiles("global_sort_tiles", keys, tile, min_tile=2)
    if n_tiles == 0 or n_tiles & (n_tiles - 1):
        raise ValueError("global_sort_tiles: the tile count must be a power "
                         f"of two, got {n_tiles}; pad with to_tiles_pow2")
    return dev


def global_sort_tiles(keys: torch.Tensor, *, tile: int) -> torch.Tensor:
    """Sort ``keys`` ((2^k * tile,) int32, MAXI32-padded by
    ``to_tiles_pow2``) ascending; returns a new tensor."""
    global LAUNCHES, SORTED_KEYS
    dev = _check(keys, tile)
    SORTED_KEYS += keys.numel()
    if not _args.runs_kernel("global_sort_tiles", dev):
        return global_sort_ref(keys)
    out = radix_sort.sort_keys("global_sort_tiles", keys)
    LAUNCHES += 1
    return out
