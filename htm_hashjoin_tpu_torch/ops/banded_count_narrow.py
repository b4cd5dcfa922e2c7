"""K5: the narrow banded match count over already sorted tiles.

Counterpart of ``htm_hashjoin_tpu/ops/pallas/join_kernels.py:
banded_count_narrow``: K1's count half without the sort.
``banded_count_narrow`` runs the hand-written CUDA kernel
(``csrc/banded_count_narrow.cu``) on CUDA tensors and the plain torch
version ``banded_count_narrow_ref`` on CPU tensors; it raises on any other
device and never falls back.  ``narrow_count_ref`` and ``tile_key_sums``
are the plain count and key sums both K1's and K5's plain versions run;
``model_narrow_count`` is a plain model of the kernels' count, thread by
thread and search step by search step, for the CPU tests.
"""

from __future__ import annotations

import torch

from . import _args
from ._args import OV
from ..constants import LANES, MAXI32, OV_ROWS, PACK_LIMIT

# K1's and K5's tiles: (keys a thread, threads) of each, as the kernels
# instantiate them (K2's register tiles).
KERNEL_SHAPES = {2048: (4, 512), 4096: (8, 512), 8192: (16, 512),
                 16384: (16, 1024)}
KERNEL_TILES = tuple(KERNEL_SHAPES)

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


def tile_key_sums(v):
    """Per (F, tile) tile: the sum of its keys below MAXI32 (padding left
    out), int64: the join's conservation check."""
    return torch.where(v == MAXI32, 0, v).sum(1, dtype=torch.int64)


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
    v = r_sorted.view(n_tiles, tile)
    return (*narrow_count_ref(v, s_padded, row_off, rows_needed, tile),
            tile_key_sums(v))


def _gallop(a, lo, n, key, strict):
    """The kernels' gallop (banded_common.cuh), step for step."""
    hi, step = n, 1
    while lo + step - 1 < n:
        x = a[lo + step - 1]
        if x < key or (strict and x == key):
            lo += step
            step <<= 1
        else:
            hi = lo + step - 1
            break
    while lo < hi:
        mid = (lo + hi) >> 1
        x = a[mid]
        if x < key or (strict and x == key):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _lower_bound(a, n, key):
    """The kernels' lower_bound: the first index in a[0, n) whose key is
    >= key, by a binary search."""
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[mid] < key:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _count_chunk(x, band, n):
    """The kernels' count_chunk: one thread's keys x against the sorted
    band[0, n), the first searched key by a binary search, the next ones
    galloping from where the last ended, a repeated key reusing the last
    count, a key outside [band[0], band[n - 1]] or at PACK_LIMIT or above
    not searched."""
    lo, hi = band[0], band[n - 1]
    cnt, pos, last = 0, -1, 0
    for j, k in enumerate(x):
        if k < lo or k > hi or k >= PACK_LIMIT:
            continue
        if j > 0 and k == x[j - 1]:
            cnt += last
            continue
        left = (_lower_bound(band, n, k) if pos < 0
                else _gallop(band, pos, n, k, False))
        right = _gallop(band, left, n, k, True)
        last, pos = right - left, right
        cnt += last
    return cnt


def model_narrow_count(r_sorted, s_padded, row_off, rows_needed, *,
                       tile: int):
    """Plain model of K1's and K5's count (CPU tests only), thread by thread
    as the kernels run it: thread p holds keys [p*E, (p+1)*E) of the tile
    (E keys a thread, ``KERNEL_SHAPES``) and counts them against band[0,
    tile), and, if they lie in the tile's last OV keys, against the
    overhang band[tile, tile + OV); mx_pre is the max of the threads' keys
    in the row before the overhang's.  A band past the end of ``s_padded``
    reads nothing and gets flag 2.  Returns ``(counts int64, flags int32,
    key sums int64)``."""
    _, n_tiles = check_band_args("banded_count_narrow", r_sorted, s_padded,
                                 row_off, rows_needed, tile)
    e = KERNEL_SHAPES[tile][0]
    tiles = r_sorted.view(n_tiles, tile)
    rows = tile // LANES
    counts, flags = [], []
    for t in range(n_tiles):
        start = int(row_off[t]) * LANES
        x = tiles[t].tolist()
        if start < 0 or start + tile + OV > s_padded.numel():
            counts.append(0)
            flags.append(2)
            continue
        band = s_padded[start:start + tile + OV].tolist()
        cnt = 0
        for first in range(0, tile, e):
            keys = x[first:first + e]
            cnt += _count_chunk(keys, band, tile)
            if first >= tile - OV:
                cnt += _count_chunk(keys, band[tile:], OV)
        mx_pre = max(x[tile - OV - LANES:tile - OV])
        need = int(rows_needed[t])
        ok = need <= rows or (mx_pre < band[tile] and need <= rows + OV_ROWS)
        counts.append(cnt if ok else 0)
        flags.append(0 if ok else 1)
    dev = r_sorted.device
    return (torch.tensor(counts, dtype=torch.int64, device=dev),
            torch.tensor(flags, dtype=torch.int32, device=dev),
            tile_key_sums(tiles))


def banded_count_narrow(r_sorted, s_padded, row_off, rows_needed, *,
                        tile: int):
    """Narrow-band match counts of tile-sorted R against sorted S.

    Arguments: ``r_sorted`` (F*tile,) int32, each tile sorted; ``s_padded``
    the sorted probe side end-padded by ``prepare_probe_side``; ``row_off``
    (F,) int32 band start rows; ``rows_needed`` (F,) int32 band widths in
    rows.

    Returns ``(counts int64 (F,), flags int32 (F,), key sums int64 (F,))``:
    flags[t] == 1 marks a tile to recount exactly (count 0); on CUDA, 2
    marks a band that would end past ``s_padded`` (nothing read, counted
    0), where the plain version raises; sums[t] is the sum of tile t's keys
    below MAXI32.  The JAX function returns an (8, 128) int32 grid of
    partial sums and (F, 128) flag rows instead: the one deliberate layout
    change, as for K1.  The JAX kernel's ``unique_both`` shortcut is exact
    only for unique keys; the general count here is exact for both."""
    dev, n_tiles = check_band_args("banded_count_narrow", r_sorted, s_padded,
                                   row_off, rows_needed, tile)
    if not _args.runs_kernel("banded_count_narrow", dev):
        return banded_count_narrow_ref(r_sorted, s_padded, row_off,
                                       rows_needed, tile=tile)
    _args.kernel_tile("banded_count_narrow", tile, KERNEL_TILES)
    _args.aligned("banded_count_narrow", r_sorted=r_sorted,
                  s_padded=s_padded)
    counts = torch.empty((n_tiles,), dtype=torch.int64, device=dev)
    flags = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    sums = torch.empty((n_tiles,), dtype=torch.int64, device=dev)
    if n_tiles:
        _launch(r_sorted, s_padded, row_off, rows_needed, counts, flags, sums,
                n_tiles, tile)
    return counts, flags, sums


def _launch(r_sorted, s_padded, row_off, rows_needed, counts, flags, sums,
            n_tiles, tile):
    global LAUNCHES
    _args.launch("banded_count_narrow", "htm_banded_count_narrow",
                 r_sorted.device, r_sorted.data_ptr(), s_padded.data_ptr(),
                 s_padded.numel(), row_off.data_ptr(), rows_needed.data_ptr(),
                 counts.data_ptr(), flags.data_ptr(), sums.data_ptr(),
                 n_tiles, tile)
    LAUNCHES += 1
