"""The band geometry's prepass: each unsorted tile's min and max.

K1 takes its S band offsets from the sort-invariant [min, max without
MAXI32 padding] of each unsorted tile (the JAX package's
``pallas_backend._tile_minmax``, left to XLA there).  ``tile_minmax`` runs
the hand-written CUDA prepass (``htm_tile_minmax`` in
``csrc/fused_sort_count.cu``: one read of R) on CUDA tensors and the plain
torch version ``tile_minmax_ref`` on CPU tensors; it raises on any other
device and never falls back from one to the other.  It is glue of the
port, not a TPU kernel.
"""

from __future__ import annotations

import torch

from . import _args
from ..constants import INT32_MIN, MAXI32

LAUNCHES = 0   # kernel launches by tile_minmax (the plain path adds none)


def _check(r_flat, tile):
    dev = _args.int32_vectors("tile_minmax", r_flat=r_flat)
    return dev, _args.n_tiles("tile_minmax", r_flat, tile, min_tile=4)


def tile_minmax_ref(r_flat: torch.Tensor, tile: int):
    """Plain torch version (any device)."""
    _check(r_flat, tile)
    tiles = r_flat.view(-1, tile)
    mins = tiles.amin(1)
    maxs = torch.where(tiles == MAXI32, INT32_MIN, tiles).amax(1)
    return mins, maxs


def tile_minmax(r_flat: torch.Tensor, tile: int):
    """Per-tile (mins, maxs) int32 of the UNSORTED, MAXI32-padded build side
    ``r_flat`` (F*tile,): maxs leave MAXI32 padding out, so a fully padded
    tile has min MAXI32 and max INT32_MIN."""
    dev, n_tiles = _check(r_flat, tile)
    if not _args.runs_kernel("tile_minmax", dev):
        return tile_minmax_ref(r_flat, tile)
    _args.aligned("tile_minmax", r_flat=r_flat)
    out = torch.empty((2, n_tiles), dtype=torch.int32, device=dev)
    if n_tiles:
        _launch(r_flat, out, n_tiles, tile)
    return out[0], out[1]


def _launch(r_flat, out, n_tiles, tile):
    global LAUNCHES
    _args.launch("tile_minmax", "htm_tile_minmax", r_flat.device,
                 r_flat.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                 n_tiles, tile)
    LAUNCHES += 1
