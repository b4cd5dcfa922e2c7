"""K1: fused tile sort + narrow banded match count.

Counterpart of ``htm_hashjoin_tpu/ops/pallas/join_kernels.py:
fused_sort_count``.  ``fused_sort_count`` runs the hand-written CUDA kernel
(``csrc/fused_sort_count.cu``) on CUDA tensors and the plain torch version
``fused_sort_count_ref`` on CPU tensors; it raises on any other device and
never falls back from one to the other.
"""

from __future__ import annotations

import torch

from . import _build
from .sorters import sort_tiles
from ..constants import INT32_MIN, LANES, MAXI32, OV_ROWS, PACK_LIMIT

OV = OV_ROWS * LANES
METHODS = {"bitonic": 0, "blocks": 1, "oddeven": 2}
# The kernel holds 2*tile + OV int32 keys in shared memory (227 KB a block).
KERNEL_TILES = (2048, 4096, 8192, 16384)

LAUNCHES = 0   # kernel launches by fused_sort_count (the plain path adds none)


def _check_args(r_flat, s_padded, row_off, rows_needed, tile, method,
                passes):
    tensors = (r_flat, s_padded, row_off, rows_needed)
    if not all(isinstance(x, torch.Tensor) for x in tensors):
        raise TypeError("fused_sort_count takes torch tensors")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("fused_sort_count: tensors on different devices")
    for name, x in zip(("r_flat", "s_padded", "row_off", "rows_needed"),
                       tensors):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"fused_sort_count: {name} must be a contiguous "
                             f"1-D int32 tensor, got {x.dtype} {tuple(x.shape)}")
    if tile <= OV or tile & (tile - 1):
        raise ValueError(f"tile must be a power of two > {OV}, got {tile}")
    if r_flat.numel() % tile:
        raise ValueError(f"r_flat holds {r_flat.numel()} keys, not a "
                         f"multiple of tile={tile}")
    n_tiles = r_flat.numel() // tile
    if row_off.numel() != n_tiles or rows_needed.numel() != n_tiles:
        raise ValueError(f"row_off and rows_needed need {n_tiles} entries")
    if s_padded.numel() < tile + OV:
        raise ValueError("s_padded is shorter than one band; build it with "
                         "prepare_probe_side")
    if method not in METHODS:
        raise ValueError(f"unknown sort method {method!r}")
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    return n_tiles


def fused_sort_count_ref(r_flat, s_padded, row_off, rows_needed, *,
                         tile: int, method: str, passes: int = 1,
                         unique_both: bool = False):
    """Plain torch version of K1 (any device).  Same arguments and results
    as ``fused_sort_count``; a band past the end of ``s_padded`` raises."""
    n_tiles = _check_args(r_flat, s_padded, row_off, rows_needed, tile,
                          method, passes)
    dev = r_flat.device
    v = sort_tiles(r_flat.view(n_tiles, tile), method, passes)
    stats = torch.zeros((n_tiles, 3), dtype=torch.int32, device=dev)
    if n_tiles == 0:
        return (v.reshape(-1), stats, torch.zeros(0, dtype=torch.int64,
                                                  device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    stats[:, 0] = v.amin(1)
    stats[:, 1] = torch.where(v == MAXI32, INT32_MIN, v).amax(1)
    if method != "bitonic":
        stats[:, 2] = (v[:, :-1] > v[:, 1:]).sum(1, dtype=torch.int32)

    start = row_off.to(torch.int64) * LANES
    if int(start.min()) < 0 or int(start.max()) + tile + OV > s_padded.numel():
        raise ValueError("an S band runs past the end of s_padded; build it "
                         "with prepare_probe_side")
    band = s_padded[start[:, None]
                    + torch.arange(tile + OV, device=dev)]
    counts = (_pairs(v, band[:, :tile])
              + _pairs(v[:, tile - OV:], band[:, tile:]))
    rpt = tile // LANES
    mx_pre = v[:, tile - OV - LANES:tile - OV].amax(1)
    ovh_min = band[:, tile:tile + LANES].amin(1)
    ok = (rows_needed <= rpt) | ((mx_pre < ovh_min)
                                 & (rows_needed <= rpt + OV_ROWS))
    counts = torch.where(ok, counts, 0)
    return v.reshape(-1), stats, counts, (~ok).to(torch.int32)


def _pairs(keys, band):
    """Per tile: the number of (key, band key) pairs with equal keys below
    PACK_LIMIT (each band row is sorted)."""
    band = band.contiguous()
    keys = keys.contiguous()
    lo = torch.searchsorted(band, keys, side="left")
    hi = torch.searchsorted(band, keys, side="right")
    return torch.where(keys < PACK_LIMIT, hi - lo, 0).sum(1)


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
    (F,), flags int32 (F,))``: stats are [min, max without padding, adjacent
    inversions]; counts[t] is tile t's match count, 0 where flags[t] != 0.
    flags[t] == 1 marks a tile to recount exactly; on CUDA, 2 marks a band
    that would end past ``s_padded`` (nothing read, counted 0), where the
    plain version raises.  This is the one deliberate layout change from
    the JAX function, which returns 128-lane stats and flags rows and
    (8, 128) int32 partial sums in place of per-tile int64 counts.

    Counts are defined only for tiles whose inversions are 0: the JAX kernel
    merges assuming a sorted tile, and its callers discard the count and
    retry when inversions appear.
    """
    n_tiles = _check_args(r_flat, s_padded, row_off, rows_needed, tile,
                          method, passes)
    kind = r_flat.device.type
    if kind == "cpu":
        return fused_sort_count_ref(r_flat, s_padded, row_off, rows_needed,
                                    tile=tile, method=method, passes=passes,
                                    unique_both=unique_both)
    if kind != "cuda":
        raise ValueError(f"fused_sort_count runs on cpu or cuda tensors, "
                         f"not {kind}")
    return _launch(r_flat, s_padded, row_off, rows_needed, n_tiles, tile,
                   method, passes)


def _launch(r_flat, s_padded, row_off, rows_needed, n_tiles, tile, method,
            passes):
    global LAUNCHES
    if not torch.cuda.is_available():
        raise RuntimeError("fused_sort_count got CUDA tensors but CUDA is "
                           "not available")
    if tile not in KERNEL_TILES:
        raise ValueError(f"the CUDA kernel takes tile in {KERNEL_TILES}, "
                         f"got {tile}")
    for name, x in (("r_flat", r_flat), ("s_padded", s_padded)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    dev = r_flat.device
    sorted_flat = torch.empty_like(r_flat)
    stats = torch.empty((n_tiles, 3), dtype=torch.int32, device=dev)
    counts = torch.empty((n_tiles,), dtype=torch.int64, device=dev)
    flags = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    if n_tiles == 0:
        return sorted_flat, stats, counts, flags
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.htm_fused_sort_count(
            r_flat.data_ptr(), s_padded.data_ptr(), s_padded.numel(),
            row_off.data_ptr(), rows_needed.data_ptr(), sorted_flat.data_ptr(),
            stats.data_ptr(), counts.data_ptr(), flags.data_ptr(), n_tiles,
            tile, METHODS[method], passes, stream)
    _build.check(code, "fused_sort_count launch")
    LAUNCHES += 1
    return sorted_flat, stats, counts, flags
