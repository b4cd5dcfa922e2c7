"""K1: fused tile sort + narrow banded match count.

Counterpart of ``htm_hashjoin_tpu/ops/pallas/join_kernels.py:
fused_sort_count``.  ``fused_sort_count`` runs the hand-written CUDA kernel
(``csrc/fused_sort_count.cu``) on CUDA tensors and the plain torch version
``fused_sort_count_ref`` on CPU tensors; it raises on any other device and
never falls back from one to the other.
"""

from __future__ import annotations

import torch

from . import _args
from .banded_count_narrow import (KERNEL_TILES, check_band_args,
                                  narrow_count_ref, tile_key_sums)
from .sort_tiles import stats_rows
from .sorters import METHODS, sort_tiles

K1_METHODS = ("bitonic", "blocks", "oddeven")

LAUNCHES = 0   # kernel launches by fused_sort_count (the plain path adds none)


def _check_args(r_flat, s_padded, row_off, rows_needed, tile, method,
                passes):
    dev, n_tiles = check_band_args("fused_sort_count", r_flat, s_padded,
                                   row_off, rows_needed, tile)
    if method not in K1_METHODS:
        raise ValueError(f"unknown sort method {method!r}")
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    return dev, n_tiles


def fused_sort_count_ref(r_flat, s_padded, row_off, rows_needed, *,
                         tile: int, method: str, passes: int = 1,
                         unique_both: bool = False):
    """Plain torch version of K1 (any device): the plain sorter, the stats
    rows, the plain narrow count (``narrow_count_ref``, shared with K5) and
    the key sums of the input and the sorted tiles.  Same arguments and
    results as ``fused_sort_count``; a band past the end of ``s_padded``
    raises."""
    _, n_tiles = _check_args(r_flat, s_padded, row_off, rows_needed, tile,
                             method, passes)
    r = r_flat.view(n_tiles, tile)
    v = sort_tiles(r, method, passes)
    counts, flags = narrow_count_ref(v, s_padded, row_off, rows_needed, tile)
    return (v.reshape(-1), stats_rows(v, method), counts, flags,
            tile_key_sums(r), tile_key_sums(v))


def fused_sort_count(r_flat, s_padded, row_off, rows_needed, *, tile: int,
                     method: str, passes: int = 1, unique_both: bool = False):
    """Fused tile sort + narrow banded count of an unsorted, MAXI32-padded
    build side against its sorted probe side.

    Arguments: ``r_flat`` (F*tile,) int32; ``s_padded`` the sorted probe side
    end-padded by ``prepare_probe_side``; ``row_off`` (F,) int32 band start
    rows (128 keys a row); ``rows_needed`` (F,) int32 band widths in rows.
    ``unique_both`` is accepted for the JAX signature: the general count is
    exact whenever its precondition holds, so both run it.

    Returns ``(sorted_flat int32 (F*tile,), stats int32 (F, 3), counts int64
    (F,), flags int32 (F,), in_sums int64 (F,), out_sums int64 (F,))``:
    stats are [min, max without padding, adjacent inversions]; counts[t] is
    tile t's match count, 0 where flags[t] != 0.  flags[t] == 1 marks a
    tile to recount exactly; on CUDA, 2 marks a band that would end past
    ``s_padded`` (nothing read, counted 0), where the plain version raises.
    in_sums[t] and out_sums[t] are the sums of tile t's keys below MAXI32
    before and after the sort (equal unless the sort lost a key).  This is
    the one deliberate layout change from the JAX function, which returns
    128-lane stats and flags rows and (8, 128) int32 partial sums in place
    of per-tile int64 counts, and leaves the key sums to its caller.

    Counts are defined only for tiles whose inversions are 0: the JAX kernel
    merges assuming a sorted tile, and its callers discard the count and
    retry when inversions appear.
    """
    dev, n_tiles = _check_args(r_flat, s_padded, row_off, rows_needed, tile,
                               method, passes)
    if not _args.runs_kernel("fused_sort_count", dev):
        return fused_sort_count_ref(r_flat, s_padded, row_off, rows_needed,
                                    tile=tile, method=method, passes=passes,
                                    unique_both=unique_both)
    _args.kernel_tile("fused_sort_count", tile, KERNEL_TILES)
    _args.aligned("fused_sort_count", r_flat=r_flat, s_padded=s_padded)
    sorted_flat = torch.empty_like(r_flat)
    stats = torch.empty((n_tiles, 3), dtype=torch.int32, device=dev)
    counts = torch.empty((n_tiles,), dtype=torch.int64, device=dev)
    flags = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    sums = torch.empty((2, n_tiles), dtype=torch.int64, device=dev)
    if n_tiles:
        _launch(r_flat, s_padded, row_off, rows_needed, sorted_flat, stats,
                counts, flags, sums, n_tiles, tile, method, passes)
    return sorted_flat, stats, counts, flags, sums[0], sums[1]


def _launch(r_flat, s_padded, row_off, rows_needed, sorted_flat, stats,
            counts, flags, sums, n_tiles, tile, method, passes):
    global LAUNCHES
    _args.launch("fused_sort_count", "htm_fused_sort_count", r_flat.device,
                 r_flat.data_ptr(), s_padded.data_ptr(), s_padded.numel(),
                 row_off.data_ptr(), rows_needed.data_ptr(),
                 sorted_flat.data_ptr(), stats.data_ptr(), counts.data_ptr(),
                 flags.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
                 n_tiles, tile, METHODS[method], passes)
    LAUNCHES += 1
