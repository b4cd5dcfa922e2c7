"""K3: global ascending sort of a power-of-two count of tiles.

Counterpart of ``htm_hashjoin_tpu/ops/pallas/join_kernels.py:
global_sort_tiles``.  On CUDA tensors ``global_sort_tiles`` runs the
bitonic network in two kernels: K2 (``sort_tiles``, method "bitonic_alt")
sorts blocks of up to ``GSORT_BLOCK`` keys in alternating directions
(phase A, as the JAX function's first pass), then the hand-written K3
(``csrc/global_sort.cu``) runs every longer level in place.  On CPU tensors
it runs the plain version, ``torch.sort``; any other device raises, and
nothing falls back.  The port is held to the output only: the sorted keys,
MAXI32 padding last.
"""

from __future__ import annotations

import torch

from . import _args
from .sort_tiles import sort_tiles

GSORT_BLOCK = 32768   # phase A's block: the largest tile K2 holds

LAUNCHES = 0   # K3 launches (each runs all levels past phase A)


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
    dev = _check(keys, tile)
    if not _args.runs_kernel("global_sort_tiles", dev):
        return global_sort_ref(keys)
    n = keys.numel()
    block = min(n, GSORT_BLOCK)
    out, _ = sort_tiles(keys, tile=block,
                        method="bitonic" if n == block else "bitonic_alt")
    if n > block:
        _launch(out, n, block)
    return out


def _launch(keys, n, block):
    global LAUNCHES
    _args.aligned("global_sort_tiles", keys=keys)
    _args.launch("global_sort_tiles", "htm_global_sort_levels", keys.device,
                 keys.data_ptr(), n, block)
    LAUNCHES += 1
