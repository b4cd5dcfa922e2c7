"""K4: the general banded match count.

Counterpart of ``htm_hashjoin_tpu/ops/pallas/join_kernels.py:
banded_count``.  ``banded_count`` runs the hand-written CUDA kernel
(``csrc/banded_count.cu``) on CUDA tensors and the plain torch version
``banded_count_ref`` on CPU tensors; it raises on any other device and
never falls back from one to the other.
"""

from __future__ import annotations

import torch

from . import _args
from ..constants import LANES, PACK_LIMIT

# Shared memory holds the tile and one chunk (2 * tile int32).
KERNEL_TILES = (2048, 4096, 8192, 16384)

LAUNCHES = 0   # kernel launches by banded_count (the plain path adds none)


def _check(r_sorted, s_padded, row_off, n_chunks, tile):
    dev = _args.int32_vectors("banded_count", r_sorted=r_sorted,
                              s_padded=s_padded, row_off=row_off,
                              n_chunks=n_chunks)
    n_tiles = _args.n_tiles("banded_count", r_sorted, tile)
    _args.per_tile("banded_count", n_tiles, row_off=row_off,
                   n_chunks=n_chunks)
    return dev, n_tiles


def banded_count_ref(r_sorted, s_padded, row_off, n_chunks, *, tile: int):
    """Plain torch version of K4 (any device): per tile, the pairs of equal
    keys below PACK_LIMIT between the tile and its chunks, from one
    searchsorted per key over the sorted ``s_padded`` clipped to the band
    ``[row_off*128, + n_chunks*tile)``.  A band past the end of s_padded
    raises."""
    dev, n_tiles = _check(r_sorted, s_padded, row_off, n_chunks, tile)
    start = row_off.to(torch.int64) * LANES
    end = start + n_chunks.to(torch.int64) * tile
    live = n_chunks > 0
    if bool((live & ((start < 0) | (end > s_padded.numel()))).any()):
        raise ValueError("banded_count: a chunk runs past the end of "
                         "s_padded; build it with prepare_probe_side")
    v = r_sorted.view(n_tiles, tile)
    lo = torch.searchsorted(s_padded, v, side="left")
    hi = torch.searchsorted(s_padded, v, side="right")
    start, end = start[:, None], end[:, None]
    pairs = (torch.minimum(torch.maximum(hi, start), end)
             - torch.minimum(torch.maximum(lo, start), end))
    counts = torch.where((v < PACK_LIMIT) & live[:, None], pairs, 0).sum(1)
    return counts, torch.zeros(n_tiles, dtype=torch.int32, device=dev)


def banded_count(r_sorted, s_padded, row_off, n_chunks, *, tile: int):
    """Match counts of tile-sorted R against sorted S in chunks.

    Arguments: ``r_sorted`` (F*tile,) int32, each tile sorted; ``s_padded``
    the sorted probe side, end-padded by ``prepare_probe_side``; ``row_off``
    (F,) int32 band start rows (128 keys a row); ``n_chunks`` (F,) int32
    tile-sized chunks per band, unbounded (0 skips the tile).

    Returns ``(counts int64 (F,), status int32 (F,))``: counts[t] is tile
    t's match count; status[t] is 0, or on CUDA 2 where the chunks would
    end past ``s_padded`` (nothing read, counted 0; the plain version
    raises).  This is the one deliberate layout change from the JAX
    function, which returns an (8, 128) int32 grid of partial sums whose
    accumulator needs an overflow certificate; per-tile int64 counts need
    none.  Counts are defined for sorted tiles, as in the JAX kernel."""
    dev, n_tiles = _check(r_sorted, s_padded, row_off, n_chunks, tile)
    if not _args.runs_kernel("banded_count", dev):
        return banded_count_ref(r_sorted, s_padded, row_off, n_chunks,
                                tile=tile)
    _args.kernel_tile("banded_count", tile, KERNEL_TILES)
    _args.aligned("banded_count", r_sorted=r_sorted, s_padded=s_padded)
    counts = torch.empty((n_tiles,), dtype=torch.int64, device=dev)
    status = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    if n_tiles:
        _launch(r_sorted, s_padded, row_off, n_chunks, counts, status,
                n_tiles, tile)
    return counts, status


def _launch(r_sorted, s_padded, row_off, n_chunks, counts, status, n_tiles,
            tile):
    global LAUNCHES
    _args.launch("banded_count", "htm_banded_count", r_sorted.device,
                 r_sorted.data_ptr(), s_padded.data_ptr(), s_padded.numel(),
                 row_off.data_ptr(), n_chunks.data_ptr(), counts.data_ptr(),
                 status.data_ptr(), n_tiles, tile)
    LAUNCHES += 1
