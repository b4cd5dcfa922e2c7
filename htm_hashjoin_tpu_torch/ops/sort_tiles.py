"""K2: streaming per-tile sort with a stats row per tile.

Counterpart of ``htm_hashjoin_tpu/ops/pallas/join_kernels.py: sort_tiles``
(and of its XLA companion ``tile_stats``).  ``sort_tiles`` runs the
hand-written CUDA kernel (``csrc/sort_tiles.cu``) on CUDA tensors and the
plain torch version ``sort_tiles_ref`` on CPU tensors; it raises on any
other device and never falls back from one to the other.
"""

from __future__ import annotations

import torch

from . import _args
from .sorters import METHODS, sort_tiles as _sort_rows
from ..constants import INT32_MIN, MAXI32

# Shared memory holds one tile (227 KB a block): up to 32768 keys.
KERNEL_TILES = (2048, 4096, 8192, 16384, 32768)
INEXACT = ("blocks", "oddeven")   # the sorters whose inversions are counted

LAUNCHES = 0   # kernel launches by sort_tiles (the plain path adds none)


def stats_rows(v: torch.Tensor, method: str) -> torch.Tensor:
    """(F, 3) int32 stats of sorted (F, T) tiles, as the kernels write them:
    [min, max without MAXI32 padding, adjacent inversions], inversions 0 for
    the exact sorters."""
    stats = torch.zeros((v.shape[0], 3), dtype=torch.int32, device=v.device)
    if v.shape[0]:
        stats[:, 0] = v.amin(1)
        stats[:, 1] = torch.where(v == MAXI32, INT32_MIN, v).amax(1)
        if method in INEXACT:
            stats[:, 2] = (v[:, :-1] > v[:, 1:]).sum(1, dtype=torch.int32)
    return stats


def tile_stats(sorted_flat: torch.Tensor, tile: int):
    """Per-tile (mins, maxs, violations) of a tile-sorted relation, computed
    over the flat keys (``join_kernels.tile_stats``).  ``mins`` is each
    tile's FIRST key, as in the JAX function: it equals the minimum only
    where the tile is sorted.  maxs exclude MAXI32 padding; violations are
    int64 counts of adjacent inversions."""
    tiles = sorted_flat.view(-1, tile)
    mins = tiles[:, 0].clone()
    maxs = torch.where(tiles == MAXI32, INT32_MIN, tiles).amax(1)
    viols = (tiles[:, 1:] < tiles[:, :-1]).sum(1, dtype=torch.int64)
    return mins, maxs, viols


def _check(keys, tile, method, passes):
    dev = _args.int32_vectors("sort_tiles", keys=keys)
    n_tiles = _args.n_tiles("sort_tiles", keys, tile, min_tile=2)
    if method not in METHODS:
        raise ValueError(f"sort_tiles: unknown sort method {method!r}")
    if passes < 1:
        raise ValueError(f"sort_tiles: passes must be >= 1, got {passes}")
    return dev, n_tiles


def sort_tiles_ref(keys: torch.Tensor, *, tile: int, method: str,
                   passes: int = 1):
    """Plain torch version of K2 (any device); same results as
    ``sort_tiles``."""
    _, n_tiles = _check(keys, tile, method, passes)
    v = _sort_rows(keys.view(n_tiles, tile), method, passes)
    return v.reshape(-1), stats_rows(v, method)


def sort_tiles(keys: torch.Tensor, *, tile: int, method: str,
               passes: int = 1):
    """Sort every ``tile``-key tile of ``keys`` ((F*tile,) int32,
    MAXI32-padded) by ``method``: "bitonic" (exact), "bitonic_alt" (exact,
    descending on odd tiles), "blocks" (exact for displacement <= passes)
    or "oddeven" (``passes`` transposition rounds).

    Returns ``(sorted_flat int32 (F*tile,), stats int32 (F, 3))`` with stats
    rows [min, max without padding, adjacent inversions] (inversions 0 for
    the two bitonic sorters).  This is the one deliberate layout change from
    the JAX function, which returns 128-lane stats rows."""
    dev, n_tiles = _check(keys, tile, method, passes)
    if not _args.runs_kernel("sort_tiles", dev):
        return sort_tiles_ref(keys, tile=tile, method=method, passes=passes)
    _args.kernel_tile("sort_tiles", tile, KERNEL_TILES)
    _args.aligned("sort_tiles", keys=keys)
    out = torch.empty_like(keys)
    stats = torch.empty((n_tiles, 3), dtype=torch.int32, device=dev)
    if n_tiles:
        _launch(keys, out, stats, n_tiles, tile, method, passes)
    return out, stats


def _launch(keys, out, stats, n_tiles, tile, method, passes):
    global LAUNCHES
    _args.launch("sort_tiles", "htm_sort_tiles", keys.device, keys.data_ptr(),
                 out.data_ptr(), stats.data_ptr(), n_tiles, tile,
                 METHODS[method], passes)
    LAUNCHES += 1
