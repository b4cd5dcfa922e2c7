"""K4: the general banded match count.

Counterpart of ``htm_hashjoin_tpu/ops/pallas/join_kernels.py:
banded_count``.  ``banded_count`` runs the hand-written CUDA kernel
(``csrc/banded_count.cu``) on CUDA tensors and the plain torch version
``banded_count_ref`` on CPU tensors; it raises on any other device and
never falls back from one to the other.

The kernel takes its work in items of ``ITEM_CHUNKS`` chunks of one tile,
so a band of thousands of chunks spreads over the card; ``item_plan``
lists them (on the device, with no readback).  ``model_count`` is a plain
model of the kernel's per-item count, with its one-key shortcut, for the
CPU tests.
"""

from __future__ import annotations

import torch

from . import _args
from ..constants import LANES, PACK_LIMIT

# Shared memory holds two chunks, each padded by 4 words in 32 (2.25 * tile).
KERNEL_TILES = (2048, 4096, 8192, 16384)
ITEM_CHUNKS = 8   # chunks of one tile an item (csrc: kItemChunks)

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


def item_plan(n_chunks):
    """The kernel's work list.  A tile's chunks come in
    ``ceil(n_chunks / ITEM_CHUNKS)`` items: its first is item ``t`` (block
    ``t``; empty for a tile of 0 chunks), the others are listed after all
    tiles' first items (the blocks past ``n_tiles`` stride over them).
    Returns ``extra_end`` (int64 per tile), the inclusive prefix sum of
    each tile's items past its first (see ``item_range``)."""
    extra = (n_chunks - 1).clamp_(min=0).div_(ITEM_CHUNKS,
                                              rounding_mode="floor")
    return torch.cumsum(extra, 0, dtype=torch.int64)


def item_count(extra_end) -> int:
    """The number of items the kernel walks (empty ones included)."""
    return extra_end.numel() + (int(extra_end[-1]) if extra_end.numel()
                                else 0)


def item_range(k: int, n_chunks, extra_end):
    """Item ``k``'s (tile, first chunk, chunk count), as the kernel finds
    them; the count is 0 or less for a skipped tile's first item."""
    n_tiles = n_chunks.numel()
    t, c0 = k, 0
    if k >= n_tiles:
        e = k - n_tiles
        t = int(torch.searchsorted(extra_end, e, right=True))
        c0 = (e - (int(extra_end[t - 1]) if t else 0) + 1) * ITEM_CHUNKS
    return t, c0, min(ITEM_CHUNKS, int(n_chunks[t]) - c0)


def model_count(r_sorted, s_padded, row_off, n_chunks, *, tile: int):
    """Plain model of the kernel, item by item (CPU tests only): a tile
    whose chunks would end past ``s_padded`` reads nothing and gets status
    2; within an item, chunks stop at the first that starts at PACK_LIMIT
    or above; a
    chunk whose first and last keys are equal counts the tile's copies of
    that key times ``tile`` without reading the rest; any other chunk counts
    the tile's keys in [first, last] below PACK_LIMIT by search.  Item
    counts are summed per tile.  Returns ``(counts int64, status int32)``."""
    _, n_tiles = _check(r_sorted, s_padded, row_off, n_chunks, tile)
    extra_end = item_plan(n_chunks)
    end = row_off.to(torch.int64) * LANES + n_chunks.to(torch.int64) * tile
    bad = (n_chunks > 0) & ((row_off < 0) | (end > s_padded.numel()))
    counts = torch.zeros(n_tiles, dtype=torch.int64)
    tiles = r_sorted.view(n_tiles, tile)
    for k in range(item_count(extra_end)):
        t, c0, nc = item_range(k, n_chunks, extra_end)
        x = tiles[t]
        for c in range(c0, c0 + nc if not bad[t] else c0):
            start = int(row_off[t]) * LANES + c * tile
            chunk = s_padded[start:start + tile]
            lo, hi = int(chunk[0]), int(chunk[-1])
            if lo >= PACK_LIMIT:
                break
            if lo == hi:
                counts[t] += int((x == lo).sum()) * tile
                continue
            keys = x[(x >= lo) & (x <= hi) & (x < PACK_LIMIT)]
            counts[t] += int((torch.searchsorted(chunk, keys, right=True)
                              - torch.searchsorted(chunk, keys)).sum())
    return counts, bad.to(torch.int32) * 2


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
    counts = torch.zeros((n_tiles,), dtype=torch.int64, device=dev)
    status = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    if n_tiles:
        _launch(r_sorted, s_padded, row_off, n_chunks, item_plan(n_chunks),
                counts, status, n_tiles, tile)
    return counts, status


def _launch(r_sorted, s_padded, row_off, n_chunks, extra_end, counts, status,
            n_tiles, tile):
    global LAUNCHES
    _args.launch("banded_count", "htm_banded_count", r_sorted.device,
                 r_sorted.data_ptr(), s_padded.data_ptr(), s_padded.numel(),
                 row_off.data_ptr(), n_chunks.data_ptr(), extra_end.data_ptr(),
                 n_tiles, counts.data_ptr(), status.data_ptr(), tile)
    LAUNCHES += 1
