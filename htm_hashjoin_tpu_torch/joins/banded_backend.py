"""Host orchestration of the banded build+probe join (narrow fused plan).

Counterpart of ``htm_hashjoin_tpu/joins/pallas_backend.py`` for the plan the
headline workload takes: a locality-shuffled build side R probed by a
sorted S.  Per-tile [min, max] of the unsorted R (sort-invariant) give each
tile's S band with one vectorized searchsorted; K1 (``fused_sort_count``)
then sorts every tile with the optimistic sorter the locality window picks,
counts it against its band and flags the tiles its narrow count cannot
certify.  Everything is enqueued on the device; the host reads one bundle
back.  Sortedness violations of the optimistic sorter abort the run and
retry it with the exact bitonic sort (the HTM abort -> retry analog).

Plans outside this slice raise ``NotImplementedError`` naming the ROADMAP
item that ports them; nothing falls back.  The JAX package's two-tier int32
accumulator certificate (``_acc_unsafe``) has no counterpart here: the port
counts per tile in int64, and for the narrow plan the certificate could
only trip at 2^30 keys.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..constants import INT32_MIN, LANES, MAXI32, OV_ROWS
from ..ops.fused_sort_count import fused_sort_count

# The JAX package's 65536-key tile is 256 KB of int32, more than a thread
# block's 227 KB of shared memory; 8192 keys plus a 9216-key band fit in
# about 68 KB (three blocks an SM), and 2^27 keys give 16384 tiles.
DEFAULT_TILE = 8192
MAX_CHUNKS_DEFAULT = 16   # sizes the probe side's end padding, as in JAX

_ITEM_K3_K4 = "ROADMAP queue 1 item 4 (kernels K3 and K4)"


def to_tiles(keys: torch.Tensor, tile: int) -> torch.Tensor:
    """Pad a 1-D int32 key tensor with MAXI32 to a tile multiple."""
    n = keys.numel()
    pad = -n % tile
    if pad:
        keys = torch.cat([keys, torch.full((pad,), MAXI32, dtype=torch.int32,
                                           device=keys.device)])
    return keys.contiguous()


def prepare_probe_side(skeys_sorted: torch.Tensor, tile: int = DEFAULT_TILE,
                       max_chunks: int = MAX_CHUNKS_DEFAULT) -> torch.Tensor:
    """Tile and end-pad sorted S once (reusable across probes): a band that
    starts at S's very end must still have ``tile + OV_ROWS*128`` readable
    keys.  Same padding as the JAX package: max_chunks tiles + OV_ROWS rows."""
    s = to_tiles(skeys_sorted, tile)
    end = torch.full((max_chunks * tile + OV_ROWS * LANES,), MAXI32,
                     dtype=torch.int32, device=s.device)
    return torch.cat([s, end])


def _tile_minmax(r_flat: torch.Tensor, tile: int):
    """Per-tile [min, max without padding] of the UNSORTED input; a fully
    padded tile's max is INT32_MIN."""
    tiles = r_flat.view(-1, tile)
    mins = tiles.amin(1)
    maxs = torch.where(tiles == MAXI32, INT32_MIN, tiles).amax(1)
    return mins, maxs


def _slice_offsets(skeys_sorted: torch.Tensor, mins: torch.Tensor,
                   maxs: torch.Tensor):
    """Each tile's S band [off, end): the first S key >= min and the first
    S key > max (one binary search per tile)."""
    off = torch.searchsorted(skeys_sorted, mins, side="left", out_int32=True)
    end = torch.searchsorted(skeys_sorted, maxs, side="right", out_int32=True)
    return off, end


def band_rows(r_flat: torch.Tensor, skeys_sorted: torch.Tensor, tile: int):
    """K1's band geometry for every tile of the unsorted, padded build side:
    (off, end, row_off, rows_needed), in 128-key rows for the last two."""
    off, end = _slice_offsets(skeys_sorted, *_tile_minmax(r_flat, tile))
    row_off = off // LANES
    rows_needed = torch.clamp((end + LANES - 1) // LANES - row_off, min=0)
    return off, end, row_off, rows_needed


def _sum_i64(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dtype=torch.int64)


def _sort_method(locality_window: Optional[int], tile: int):
    """The optimistic sorter for a locality window: odd-even transposition
    to w = 8, shifted blocks to w = min(512, tile/2), bitonic beyond (the
    JAX package's crossovers)."""
    w = locality_window
    if w is None or w <= 0 or w > min(512, tile // 2):
        return "bitonic", 0
    return ("oddeven", w) if w <= 8 else ("blocks", w)


class BandedJoinOutcome(NamedTuple):
    matches: int
    violations: int      # optimistic-sort failures (the abort count analog)
    overflow_tiles: int  # tiles the narrow count could not certify
    output_sum: int      # sum of keys in the build artifact
    resorted: bool       # the bitonic retry ran (TM_RETRY analog)
    input_sum: int = 0   # sum of input keys (== output_sum: no tuple lost)


def _banded_join_device(r_flat, s_padded, skeys_sorted, *, tile: int,
                        method: str, passes: int):
    """The whole join as one asynchronous device chain: band offsets from
    the unsorted tiles' min/max, then K1.  Nothing here synchronises.

    Returns (matches, violations, flagged tiles, out_sum, in_sum,
    sorted_flat, off, end, flags): five int64 scalars, then tensors."""
    off, end, row_off, rows_needed = band_rows(r_flat, skeys_sorted, tile)
    sorted_flat, stats, counts, flags = fused_sort_count(
        r_flat, s_padded, row_off, rows_needed, tile=tile, method=method,
        passes=max(1, passes))
    return (_sum_i64(counts), _sum_i64(stats[:, 2]), _sum_i64(flags > 0),
            _sum_i64(torch.where(sorted_flat == MAXI32, 0, sorted_flat)),
            _sum_i64(torch.where(r_flat == MAXI32, 0, r_flat)),
            sorted_flat, off, end, flags)


def _plan(locality_window, tile, *, presort=False, presorted=False,
          sort_s=False, unique_both=False, narrow=None):
    """(method, passes) of the fused narrow plan; other plans raise."""
    if presort or presorted or sort_s:
        raise NotImplementedError(
            "presort, presorted and sort_s plans need a global sort and the "
            f"general count: {_ITEM_K3_K4}")
    method, passes = _sort_method(locality_window, tile)
    if narrow is None:
        narrow = unique_both or method in ("oddeven", "blocks")
    if not narrow:
        raise NotImplementedError(
            "the wide-band plan (narrow=False, or no locality window without "
            f"unique_both) needs the general count: {_ITEM_K3_K4}")
    return method, passes


def enqueue_banded_join(rkeys: torch.Tensor, skeys_sorted: torch.Tensor, *,
                        tile: int = DEFAULT_TILE,
                        locality_window: Optional[int] = None,
                        unique_both: bool = False,
                        max_chunks: int = MAX_CHUNKS_DEFAULT,
                        s2d: Optional[torch.Tensor] = None):
    """Enqueue one full optimistic build+probe WITHOUT any host sync and
    return the device result tuple (matches, violations, flagged, out_sum,
    in_sum, ...).  For back-to-back throughput: enqueue K joins, read the
    last bundle once, and check violations == 0 and flagged == 0 (else run
    ``banded_join_pipelined``, which retries).  ``unique_both`` is kept for
    the JAX signature: K1's general count is exact for unique keys too."""
    r_flat = to_tiles(rkeys, tile)
    method, passes = _sort_method(locality_window, tile)
    if s2d is None:
        s2d = prepare_probe_side(skeys_sorted, tile, max_chunks)
    return _banded_join_device(r_flat, s2d, skeys_sorted, tile=tile,
                               method=method, passes=passes)


def _fence(res) -> list:
    """The one host sync: the five scalars and the per-tile flags in one
    device-to-host copy."""
    bundle = torch.cat([torch.stack(res[:5]), res[8].to(torch.int64)]).cpu()
    return bundle.tolist()


def banded_join_pipelined(rkeys: torch.Tensor, skeys_sorted: torch.Tensor, *,
                          tile: int = DEFAULT_TILE,
                          locality_window: Optional[int] = None,
                          presort: bool = False, presorted: bool = False,
                          sort_s: bool = False, unique_both: bool = False,
                          max_chunks: int = MAX_CHUNKS_DEFAULT,
                          narrow: Optional[bool] = None,
                          s2d: Optional[torch.Tensor] = None
                          ) -> BandedJoinOutcome:
    """Full build+probe with exactly one host sync on the fast path.

    The optimistic sorter streams through; violations surface in the one
    readback and trigger the exact bitonic retry, paid only on an actual
    abort.  The violation count reported is the aborted run's.  Tiles the
    narrow count flags need the repair path, which is not ported yet: they
    raise ``NotImplementedError``, as do the presort, presorted, sort_s and
    wide-band plans."""
    method, passes = _plan(locality_window, tile, presort=presort,
                           presorted=presorted, sort_s=sort_s,
                           unique_both=unique_both, narrow=narrow)
    r_flat = to_tiles(rkeys, tile)
    if s2d is None:
        s2d = prepare_probe_side(skeys_sorted, tile, max_chunks)
    bundle = _fence(_banded_join_device(r_flat, s2d, skeys_sorted, tile=tile,
                                        method=method, passes=passes))
    violations = bundle[1]
    resorted = False
    if method in ("oddeven", "blocks") and violations > 0:   # abort -> retry
        bundle = _fence(_banded_join_device(r_flat, s2d, skeys_sorted,
                                            tile=tile, method="bitonic",
                                            passes=0))
        resorted = True
    if 2 in bundle[5:]:
        raise ValueError("an S band runs past the end of s2d; build it with "
                         "prepare_probe_side for this tile")
    if bundle[2]:
        raise NotImplementedError(
            f"{bundle[2]} tiles need the exact recount of flagged or "
            f"overflowing bands: {_ITEM_K3_K4}")
    return BandedJoinOutcome(bundle[0], violations, bundle[2], bundle[3],
                             resorted, bundle[4])
