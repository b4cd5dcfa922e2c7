"""K5: the narrow banded match count over already sorted tiles.

Counterpart of ``htm_hashjoin_tpu/ops/pallas/join_kernels.py:
banded_count_narrow``: K1's count half without the sort.
``banded_count_narrow`` runs the hand-written CUDA kernel
(``csrc/banded_count_narrow.cu``) on CUDA tensors and the plain torch
version ``banded_count_narrow_ref`` on CPU tensors; it raises on any other
device and never falls back.  ``narrow_count_ref`` is the plain count both
K1's and K5's plain versions run.
"""

from __future__ import annotations

import torch

from . import _args
from ._args import OV
from ..constants import LANES, OV_ROWS, PACK_LIMIT

# Shared memory holds 2*tile + OV int32 keys (227 KB a block).
KERNEL_TILES = (2048, 4096, 8192, 16384)

LAUNCHES = 0   # kernel launches by banded_count_narrow (plain path: none)


def _pairs(keys, band):
    """Per tile: the number of (key, band key) pairs with equal keys below
    PACK_LIMIT (each band row is sorted)."""
    band = band.contiguous()
    keys = keys.contiguous()
    lo = torch.searchsorted(band, keys, side="left")
    hi = torch.searchsorted(band, keys, side="right")
    return torch.where(keys < PACK_LIMIT, hi - lo, 0).sum(1)


def narrow_count_ref(v, s_padded, row_off, rows_needed, tile: int):
    """The narrow count of sorted (F, tile) tiles ``v`` against their bands
    ``s_padded[row_off*128, + tile + OV)``: every key against the band's
    first tile keys, the tile's last OV keys also against the overhang,
    then the certificate.  Returns (counts int64 (F,), flags int32 (F,)),
    counts 0 where flags is 1.  A band past the end of s_padded raises."""
    n_tiles = v.shape[0]
    if n_tiles == 0:
        return (torch.zeros(0, dtype=torch.int64, device=v.device),
                torch.zeros(0, dtype=torch.int32, device=v.device))
    start = row_off.to(torch.int64) * LANES
    if int(start.min()) < 0 or int(start.max()) + tile + OV > s_padded.numel():
        raise ValueError("an S band runs past the end of s_padded; build it "
                         "with prepare_probe_side")
    band = s_padded[start[:, None] + torch.arange(tile + OV, device=v.device)]
    counts = (_pairs(v, band[:, :tile])
              + _pairs(v[:, tile - OV:], band[:, tile:]))
    rpt = tile // LANES
    mx_pre = v[:, tile - OV - LANES:tile - OV].amax(1)
    ovh_min = band[:, tile:tile + LANES].amin(1)
    ok = (rows_needed <= rpt) | ((mx_pre < ovh_min)
                                 & (rows_needed <= rpt + OV_ROWS))
    return torch.where(ok, counts, 0), (~ok).to(torch.int32)


def check_band_args(fn, r, s_padded, row_off, rows_needed, tile):
    """The checks K1 and K5 share; returns (device, tile count)."""
    dev = _args.int32_vectors(fn, r_flat=r, s_padded=s_padded,
                              row_off=row_off, rows_needed=rows_needed)
    n_tiles = _args.n_tiles(fn, r, tile)
    _args.per_tile(fn, n_tiles, row_off=row_off, rows_needed=rows_needed)
    if s_padded.numel() < tile + OV:
        raise ValueError(f"{fn}: s_padded is shorter than one band; build it "
                         "with prepare_probe_side")
    return dev, n_tiles


def banded_count_narrow_ref(r_sorted, s_padded, row_off, rows_needed, *,
                            tile: int):
    """Plain torch version of K5 (any device); a band past the end of
    ``s_padded`` raises."""
    _, n_tiles = check_band_args("banded_count_narrow", r_sorted, s_padded,
                                 row_off, rows_needed, tile)
    return narrow_count_ref(r_sorted.view(n_tiles, tile), s_padded, row_off,
                            rows_needed, tile)


def banded_count_narrow(r_sorted, s_padded, row_off, rows_needed, *,
                        tile: int):
    """Narrow-band match counts of tile-sorted R against sorted S.

    Arguments: ``r_sorted`` (F*tile,) int32, each tile sorted; ``s_padded``
    the sorted probe side end-padded by ``prepare_probe_side``; ``row_off``
    (F,) int32 band start rows; ``rows_needed`` (F,) int32 band widths in
    rows.

    Returns ``(counts int64 (F,), flags int32 (F,))``: flags[t] == 1 marks a
    tile to recount exactly (count 0); on CUDA, 2 marks a band that would
    end past ``s_padded`` (nothing read, counted 0), where the plain
    version raises.  The JAX function returns an (8, 128) int32 grid of
    partial sums and (F, 128) flag rows instead: the one deliberate layout
    change, as for K1.  The JAX kernel's ``unique_both`` shortcut is exact
    only for unique keys; the general count here is exact for both."""
    dev, n_tiles = check_band_args("banded_count_narrow", r_sorted, s_padded,
                                   row_off, rows_needed, tile)
    if not _args.runs_kernel("banded_count_narrow", dev):
        return narrow_count_ref(r_sorted.view(n_tiles, tile), s_padded,
                                row_off, rows_needed, tile)
    _args.kernel_tile("banded_count_narrow", tile, KERNEL_TILES)
    _args.aligned("banded_count_narrow", r_sorted=r_sorted,
                  s_padded=s_padded)
    counts = torch.empty((n_tiles,), dtype=torch.int64, device=dev)
    flags = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    if n_tiles:
        _launch(r_sorted, s_padded, row_off, rows_needed, counts, flags,
                n_tiles, tile)
    return counts, flags


def _launch(r_sorted, s_padded, row_off, rows_needed, counts, flags, n_tiles,
            tile):
    global LAUNCHES
    _args.launch("banded_count_narrow", "htm_banded_count_narrow",
                 r_sorted.device, r_sorted.data_ptr(), s_padded.data_ptr(),
                 s_padded.numel(), row_off.data_ptr(), rows_needed.data_ptr(),
                 counts.data_ptr(), flags.data_ptr(), n_tiles, tile)
    LAUNCHES += 1
