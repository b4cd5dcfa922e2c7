"""Host orchestration of the banded build+probe join, every plan.

Counterpart of ``htm_hashjoin_tpu/joins/pallas_backend.py``.  The plans:

  * fused narrow (locality windows to 512): K1 sorts each tile and counts it
    against its S band, whose offsets come from the sort-invariant per-tile
    [min, max] of the unsorted input;
  * wide band (larger windows, or none): K2 sorts each tile, then K4 counts
    it against up to ``max_chunks`` tile-sized chunks of S;
  * sort-first (``presort``: data without locality) and ``presorted``: K3
    sorts R globally (or the input already is), then K5 (unique keys) or K4
    counts it;
  * ``sort_s``: K3 sorts an unsorted probe side first.

Everything is enqueued on the device and the host reads one bundle back.
Sortedness violations of an optimistic sorter retry the join with the exact
bitonic sort (the HTM abort -> retry analog); tiles the count flags are
recounted exactly in one batched repair (K3 + K4 with unbounded chunks);
mass overflow replans (a global sort, or the skew-oblivious tagged count).

The JAX package's two-tier int32 accumulator certificate (``_acc_unsafe``,
``_max_run_length``) and its reroutes have no counterpart: K1, K4 and K5
count each tile in int64.  Its three-fence ``banded_build`` and
``banded_join`` are not ported either (only its tests call them).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..constants import INT32_MIN, LANES, MAXI32, OV_ROWS
from ..ops.banded_count import banded_count
from ..ops.banded_count_narrow import banded_count_narrow
from ..ops.fused_sort_count import fused_sort_count
from ..ops.global_sort import global_sort_tiles
from ..ops.probe import segmented_count_tagged
from ..ops.sort_tiles import sort_tiles, tile_stats

# The JAX package's 65536-key tile is 256 KB of int32, more than a thread
# block's 227 KB of shared memory; 8192 keys plus a 9216-key band fit in
# about 68 KB (three blocks an SM), and 2^27 keys give 16384 tiles.
DEFAULT_TILE = 8192
MAX_CHUNKS_DEFAULT = 16   # the general count's inline band budget, as in JAX


def to_tiles(keys: torch.Tensor, tile: int) -> torch.Tensor:
    """Pad a 1-D int32 key tensor with MAXI32 to a tile multiple."""
    n = keys.numel()
    pad = -n % tile
    if pad:
        keys = torch.cat([keys, torch.full((pad,), MAXI32, dtype=torch.int32,
                                           device=keys.device)])
    return keys.contiguous()


def to_tiles_pow2(keys: torch.Tensor, tile: int) -> torch.Tensor:
    """Like ``to_tiles`` but pads to a power-of-two tile count (at least
    one), as the global sort needs."""
    n_tiles = max(1, -(-keys.numel() // tile))
    n_tiles = 1 << (n_tiles - 1).bit_length()
    pad = n_tiles * tile - keys.numel()
    if pad:
        keys = torch.cat([keys, torch.full((pad,), MAXI32, dtype=torch.int32,
                                           device=keys.device)])
    return keys.contiguous()


def _end_pad(s: torch.Tensor, tile: int, max_chunks: int) -> torch.Tensor:
    """A band or chunk run that starts at S's very end must still be
    readable: max_chunks tiles + OV_ROWS rows of MAXI32, as in JAX."""
    end = torch.full((max_chunks * tile + OV_ROWS * LANES,), MAXI32,
                     dtype=torch.int32, device=s.device)
    return torch.cat([s, end])


def prepare_probe_side(skeys_sorted: torch.Tensor, tile: int = DEFAULT_TILE,
                       max_chunks: int = MAX_CHUNKS_DEFAULT) -> torch.Tensor:
    """Tile and end-pad sorted S once (reusable across probes)."""
    return _end_pad(to_tiles(skeys_sorted, tile), tile, max_chunks)


def sort_probe_side(skeys: torch.Tensor, tile: int = DEFAULT_TILE,
                    max_chunks: int = MAX_CHUNKS_DEFAULT):
    """Globally sort an unsorted probe side (zipf / fk / nonunique S) on the
    device with K3; returns (skeys_sorted, s_padded) for the banded plans."""
    s_sorted = global_sort_tiles(to_tiles_pow2(skeys, tile), tile=tile)
    return (s_sorted[:skeys.numel()],
            _end_pad(s_sorted, tile, max_chunks))


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
    off = torch.searchsorted(skeys_sorted, mins.contiguous(), side="left",
                             out_int32=True)
    end = torch.searchsorted(skeys_sorted, maxs.contiguous(), side="right",
                             out_int32=True)
    return off, end


def _rows(off: torch.Tensor, end: torch.Tensor):
    """(row_off, rows_needed) of bands [off, end) in 128-key rows."""
    row_off = off // LANES
    rows_needed = torch.clamp((end + LANES - 1) // LANES - row_off, min=0)
    return row_off, rows_needed


def band_rows(r_flat: torch.Tensor, skeys_sorted: torch.Tensor, tile: int):
    """K1's band geometry for every tile of the unsorted, padded build side:
    (off, end, row_off, rows_needed), in 128-key rows for the last two."""
    off, end = _slice_offsets(skeys_sorted, *_tile_minmax(r_flat, tile))
    return (off, end, *_rows(off, end))


def _n_chunks(rows_needed: torch.Tensor, tile: int) -> torch.Tensor:
    rpt = tile // LANES
    return ((rows_needed + rpt - 1) // rpt).to(torch.int32)


def _sum_i64(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dtype=torch.int64)


def _key_sum(keys: torch.Tensor) -> torch.Tensor:
    """Sum of the keys, MAXI32 padding excluded."""
    return _sum_i64(torch.where(keys == MAXI32, 0, keys))


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
    overflow_tiles: int  # tiles the count flagged for the exact recount
    output_sum: int      # sum of keys in the build artifact
    resorted: bool       # the bitonic retry (or a replan) ran
    input_sum: int = 0   # sum of input keys (== output_sum: no tuple lost)


class BandedBuild(NamedTuple):
    """The build artifact: tile-sorted runs and each tile's key range (the
    bucket directory of the banded 'hash table').  ``sorted_flat`` holds
    the JAX artifact's ``sorted2d`` bytes, flat."""
    sorted_flat: torch.Tensor   # (F*tile,) int32
    mins: torch.Tensor          # (F,) int32 per-tile min key
    maxs: torch.Tensor          # (F,) int32 per-tile max key (no padding)
    tile: int
    n: int
    violations: int
    resorted: bool


def banded_build_from_sorted(sorted_keys: torch.Tensor, *,
                             tile: int = DEFAULT_TILE) -> BandedBuild:
    """Build artifact from a globally sorted relation (the radix/sort
    path): tiles are disjoint key ranges, so bands stay narrow."""
    r_flat = to_tiles(sorted_keys, tile)
    mins, maxs, _ = tile_stats(r_flat, tile)
    return BandedBuild(r_flat, mins, maxs, tile, sorted_keys.numel(), 0,
                       False)


# ---------------------------------------------------------------------------
# Exact counts for the repair paths
# ---------------------------------------------------------------------------

def tagged_count(r_keys: torch.Tensor, skeys: torch.Tensor, *,
                 tile: int) -> torch.Tensor:
    """Skew-oblivious multiset join count (int64 device scalar): one K3
    global sort of the int32 composite key*2+tag, then a streaming
    segmented count.  Keys must be < 2^29; MAXI32 entries of R are
    padding."""
    comp_r = torch.where(r_keys == MAXI32, MAXI32, r_keys * 2)
    comp = torch.cat([comp_r.reshape(-1), skeys.reshape(-1) * 2 + 1])
    comp_sorted = global_sort_tiles(to_tiles_pow2(comp, tile), tile=tile)
    return segmented_count_tagged(comp_sorted[:comp.numel()])


def _check_status(status_max: int) -> None:
    if status_max == 2:
        raise ValueError("an S band runs past the end of s2d; build it with "
                         "prepare_probe_side for this tile")


def _overflow_tile_matches(sorted_flat: torch.Tensor,
                           skeys_sorted: torch.Tensor,
                           bad_tiles: torch.Tensor, tile: int,
                           s2d: torch.Tensor) -> int:
    """Exact match count of the flagged tiles, in one batched program.

    The bad tiles are gathered (padded with MAXI32 tiles to a power-of-two
    count), sorted globally with K3, and counted with K4 over UNBOUNDED
    chunk counts: every tile's whole S band, duplicate-multiplicity exact.
    Mass overflow (more than max(4, F/8) bad tiles) counts the gathered
    tiles with the skew-oblivious tagged sort instead.  Both count only the
    gathered tiles: the JAX function's mass branch counts the whole build,
    which its callers then add to the good tiles' matches (ADVICE r5 #1);
    that is not copied."""
    b = int(bad_tiles.numel())
    if not b:
        return 0
    n_tiles = sorted_flat.numel() // tile
    keys = sorted_flat.view(-1, tile)[bad_tiles.to(sorted_flat.device)]
    if b > max(4, n_tiles // 8):
        return int(tagged_count(keys.reshape(-1), skeys_sorted, tile=tile))
    bad_sorted = global_sort_tiles(to_tiles_pow2(keys.reshape(-1), tile),
                                   tile=tile)
    mins, maxs, _ = tile_stats(bad_sorted, tile)
    row_off, rows_needed = _rows(*_slice_offsets(skeys_sorted, mins, maxs))
    counts, status = banded_count(bad_sorted, s2d, row_off,
                                  _n_chunks(rows_needed, tile), tile=tile)
    head = torch.stack([_sum_i64(counts),
                        status.max().to(torch.int64)]).tolist()
    _check_status(head[1])
    return head[0]


# ---------------------------------------------------------------------------
# Probe of a build artifact
# ---------------------------------------------------------------------------

def banded_probe(build: BandedBuild, skeys_sorted: torch.Tensor, *,
                 max_chunks: int = MAX_CHUNKS_DEFAULT,
                 s2d: Optional[torch.Tensor] = None):
    """Probe phase: count matches of sorted S against the build artifact.
    Tiles whose band needs more than ``max_chunks`` chunks are recounted by
    the batched repair.  Returns (matches, overflow_tiles)."""
    tile = build.tile
    if s2d is None:
        s2d = prepare_probe_side(skeys_sorted, tile, max_chunks)
    row_off, rows_needed = _rows(*_slice_offsets(skeys_sorted, build.mins,
                                                 build.maxs))
    n_chunks = _n_chunks(rows_needed, tile)
    overflow = n_chunks > max_chunks
    counts, status = banded_count(build.sorted_flat, s2d, row_off,
                                  torch.where(overflow, 0, n_chunks),
                                  tile=tile)
    bundle = torch.cat([torch.stack([_sum_i64(counts),
                                     status.max().to(torch.int64)]),
                        overflow.to(torch.int64)]).cpu()
    _check_status(int(bundle[1]))
    bad_tiles = torch.nonzero(bundle[2:]).reshape(-1)
    matches = int(bundle[0]) + _overflow_tile_matches(
        build.sorted_flat, skeys_sorted, bad_tiles, tile, s2d)
    return matches, int(bad_tiles.numel())


# ---------------------------------------------------------------------------
# Fence-free pipelines
# ---------------------------------------------------------------------------

def _banded_join_device(r_flat, s_padded, skeys_sorted, *, tile: int,
                        method: str, passes: int,
                        max_chunks: int = MAX_CHUNKS_DEFAULT,
                        narrow: bool = True):
    """The whole join as one asynchronous device chain; nothing here
    synchronises.  Narrow unsorted plans run K1 on band offsets from the
    unsorted tiles' min/max; the others sort first (K2, or nothing for
    ``method == "presorted"``), then count with K5 (narrow) or K4.

    Returns (matches, violations, flagged tiles, out_sum, in_sum,
    sorted_flat, off, end, flags): five int64 scalars, then tensors; flags
    is per tile 0 (exact), 1 (recount) or 2 (band past s_padded)."""
    if narrow and method != "presorted":
        off, end, row_off, rows_needed = band_rows(r_flat, skeys_sorted,
                                                   tile)
        sorted_flat, stats, counts, flags = fused_sort_count(
            r_flat, s_padded, row_off, rows_needed, tile=tile, method=method,
            passes=max(1, passes))
        viols = stats[:, 2]
    else:
        if method == "presorted":     # globally sorted input is tile-sorted
            sorted_flat = r_flat
            mins, maxs, viols = tile_stats(sorted_flat, tile)
        else:
            sorted_flat, stats = sort_tiles(r_flat, tile=tile, method=method,
                                            passes=max(1, passes))
            mins, maxs, viols = stats[:, 0], stats[:, 1], stats[:, 2]
        off, end = _slice_offsets(skeys_sorted, mins, maxs)
        row_off, rows_needed = _rows(off, end)
        if narrow:
            counts, flags = banded_count_narrow(sorted_flat, s_padded,
                                                row_off, rows_needed,
                                                tile=tile)
        else:
            n_chunks = _n_chunks(rows_needed, tile)
            bad = n_chunks > max_chunks
            counts, status = banded_count(sorted_flat, s_padded, row_off,
                                          torch.where(bad, 0, n_chunks),
                                          tile=tile)
            flags = torch.where(status != 0, status, bad.to(torch.int32))
    return (_sum_i64(counts), _sum_i64(viols), _sum_i64(flags > 0),
            _key_sum(sorted_flat), _key_sum(r_flat), sorted_flat, off, end,
            flags)


def _prepare_join(rkeys, skeys_sorted, *, tile, locality_window, presort,
                  presorted, sort_s, unique_both, max_chunks, narrow, s2d):
    """Shared prologue of the full-join pipelines (plan -> device inputs);
    enqueues the R and S sorts, fences nothing."""
    if sort_s:
        skeys_sorted, s2d = sort_probe_side(skeys_sorted, tile, max_chunks)
    if presorted:
        r_flat, method, passes = to_tiles(rkeys, tile), "presorted", 0
    elif presort:
        r_flat = global_sort_tiles(to_tiles_pow2(rkeys, tile), tile=tile)
        method, passes = "presorted", 0
    else:
        r_flat = to_tiles(rkeys, tile)
        method, passes = _sort_method(locality_window, tile)
    if narrow is None:
        # narrow bands are certain for unique keys and expected for
        # locality-sorted builds; presorted duplicate-heavy plans can have
        # arbitrarily wide bands, so they keep the general count
        narrow = unique_both or method in ("oddeven", "blocks")
    if s2d is None:
        s2d = prepare_probe_side(skeys_sorted, tile, max_chunks)
    return r_flat, s2d, skeys_sorted, method, passes, narrow


def enqueue_banded_join(rkeys: torch.Tensor, skeys_sorted: torch.Tensor, *,
                        tile: int = DEFAULT_TILE,
                        locality_window: Optional[int] = None,
                        unique_both: bool = False,
                        max_chunks: int = MAX_CHUNKS_DEFAULT,
                        s2d: Optional[torch.Tensor] = None):
    """Enqueue one full optimistic build+probe on the fused narrow plan
    WITHOUT any host sync and return the device result tuple (matches,
    violations, flagged, out_sum, in_sum, ...).  For back-to-back
    throughput: enqueue K joins, read the last bundle once, and check
    violations == 0 and flagged == 0 (else run ``banded_join_pipelined``,
    which retries and repairs).  ``unique_both`` is kept for the JAX
    signature: the general count is exact for unique keys too."""
    r_flat = to_tiles(rkeys, tile)
    method, passes = _sort_method(locality_window, tile)
    if s2d is None:
        s2d = prepare_probe_side(skeys_sorted, tile, max_chunks)
    return _banded_join_device(r_flat, s2d, skeys_sorted, tile=tile,
                               method=method, passes=passes)


def enqueue_full_join(rkeys: torch.Tensor, skeys_sorted: torch.Tensor, *,
                      tile: int = DEFAULT_TILE,
                      locality_window: Optional[int] = None,
                      presort: bool = False, presorted: bool = False,
                      sort_s: bool = False, unique_both: bool = False,
                      max_chunks: int = MAX_CHUNKS_DEFAULT,
                      narrow: Optional[bool] = None,
                      s2d: Optional[torch.Tensor] = None):
    """Enqueue one full build+probe on ANY plan without a fence; returns the
    raw device result tuple (read ``torch.stack(res[:5])`` once)."""
    (r_flat, s2d, skeys_sorted, method, passes,
     narrow) = _prepare_join(rkeys, skeys_sorted, tile=tile,
                             locality_window=locality_window,
                             presort=presort, presorted=presorted,
                             sort_s=sort_s, unique_both=unique_both,
                             max_chunks=max_chunks, narrow=narrow, s2d=s2d)
    return _banded_join_device(r_flat, s2d, skeys_sorted, tile=tile,
                               method=method, passes=passes,
                               max_chunks=max_chunks, narrow=narrow)


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
    abort (the violation count reported is the aborted run's).  Flagged
    tiles are recounted exactly by the batched repair.  Overflow on more
    than max(4, F/8) tiles means the plan was wrong for the data: an
    unsorted plan replans as sort-first (the HTM_SWITCH analog), a sorted
    one counts everything with the tagged sort.

    ``presort`` sorts R globally first (data without locality);
    ``presorted`` takes R as already sorted; ``sort_s`` sorts an unsorted
    probe side first; ``narrow`` picks the narrow count (default: unique
    keys and locality plans)."""
    (r_flat, s2d, skeys_sorted, method, passes,
     narrow) = _prepare_join(rkeys, skeys_sorted, tile=tile,
                             locality_window=locality_window,
                             presort=presort, presorted=presorted,
                             sort_s=sort_s, unique_both=unique_both,
                             max_chunks=max_chunks, narrow=narrow, s2d=s2d)
    kw = dict(tile=tile, max_chunks=max_chunks, narrow=narrow)
    res = _banded_join_device(r_flat, s2d, skeys_sorted, method=method,
                              passes=passes, **kw)
    bundle = _fence(res)
    violations = bundle[1]
    resorted = False
    if method in ("oddeven", "blocks") and violations > 0:   # abort -> retry
        res = _banded_join_device(r_flat, s2d, skeys_sorted,
                                  method="bitonic", passes=0, **kw)
        bundle = _fence(res)
        resorted = True
    flags = bundle[5:]
    _check_status(max(flags, default=0))
    matches, overflow, out_sum, in_sum = bundle[0], bundle[2], *bundle[3:5]
    n_tiles = r_flat.numel() // tile
    if overflow > max(4, n_tiles // 8):
        if not presort and not presorted:
            out = banded_join_pipelined(rkeys, skeys_sorted, tile=tile,
                                        presort=True,
                                        unique_both=unique_both,
                                        max_chunks=max_chunks, narrow=narrow,
                                        s2d=s2d)
            return out._replace(violations=violations,
                                overflow_tiles=overflow, resorted=True)
        matches = int(tagged_count(rkeys, skeys_sorted, tile=tile))
        return BandedJoinOutcome(matches, violations, overflow, out_sum,
                                 True, in_sum)
    if overflow:                          # skew spill -> batched repair
        bad_tiles = torch.nonzero(torch.tensor(flags)).reshape(-1)
        matches += _overflow_tile_matches(res[5], skeys_sorted, bad_tiles,
                                          tile, s2d)
    return BandedJoinOutcome(matches, violations, overflow, out_sum,
                             resorted, in_sum)


# ---------------------------------------------------------------------------
# Build-only pipeline (the reference's default run, probe off)
# ---------------------------------------------------------------------------

def _tile_dup_counts(sorted_flat: torch.Tensor, tile: int) -> torch.Tensor:
    """Per-tile duplicate-alias counts: adjacent equal keys in the sorted
    tile, padding excluded (the TM_TRACK conflict-abort analog)."""
    tiles = sorted_flat.view(-1, tile)
    eq = (tiles[:, 1:] == tiles[:, :-1]) & (tiles[:, 1:] != MAXI32)
    return eq.sum(1, dtype=torch.int64)


def _enqueue_build(rkeys: torch.Tensor, *, tile: int,
                   locality_window: Optional[int], presort: bool,
                   presorted: bool, track: bool = False):
    """Enqueue the build-only device chain WITHOUT any host sync.

    Returns (head, viols, dups, r_flat, optimistic): head stacks
    [violations, outputSum, inputSum]; viols and dups are the per-tile
    violation and duplicate-alias vectors (dups only when ``track``)."""
    if presorted:
        r_flat = to_tiles(rkeys, tile)
        out_sum = _key_sum(r_flat)
        viols = torch.zeros(r_flat.numel() // tile, dtype=torch.int64,
                            device=r_flat.device)
        dups = _tile_dup_counts(r_flat, tile) if track else viols
        return (torch.stack([torch.zeros_like(out_sum), out_sum, out_sum]),
                viols, dups, r_flat, False)
    if presort:
        r_flat = to_tiles_pow2(rkeys, tile)
        sorted_flat = global_sort_tiles(r_flat, tile=tile)
        viols = torch.zeros(r_flat.numel() // tile, dtype=torch.int64,
                            device=r_flat.device)
        optimistic = False
    else:
        r_flat = to_tiles(rkeys, tile)
        method, passes = _sort_method(locality_window, tile)
        optimistic = method != "bitonic"
        sorted_flat, stats = sort_tiles(r_flat, tile=tile, method=method,
                                        passes=max(1, passes))
        viols = stats[:, 2].to(torch.int64)
    dups = (_tile_dup_counts(sorted_flat, tile) if track
            else torch.zeros_like(viols))
    head = torch.stack([_sum_i64(viols), _key_sum(sorted_flat),
                        _key_sum(r_flat)])
    return head, viols, dups, r_flat, optimistic


def enqueue_banded_build(rkeys: torch.Tensor, *, tile: int = DEFAULT_TILE,
                         locality_window: Optional[int] = None,
                         presort: bool = False,
                         presorted: bool = False) -> torch.Tensor:
    """Enqueue one build-only pipeline without a fence; returns the device
    head [violations, outputSum, inputSum] (int64).  For sustained timing:
    enqueue K, read the last head once."""
    return _enqueue_build(rkeys, tile=tile, locality_window=locality_window,
                          presort=presort, presorted=presorted)[0]


def banded_build_pipelined(rkeys: torch.Tensor, *, tile: int = DEFAULT_TILE,
                           locality_window: Optional[int] = None,
                           presort: bool = False, presorted: bool = False,
                           return_tile_violations: bool = False):
    """Build-only banded pipeline (the reference's default run with the
    probe off): the probe-able tile-sorted artifact with ONE host readback.
    Locality plans take the optimistic sorter (violations = the abort
    count, bitonic retry = TM_RETRY); others a per-tile bitonic sort;
    ``presort`` a global sort; ``presorted`` input is the artifact itself.
    matches is 0 (no probe side).

    With ``return_tile_violations`` (TM_TRACK) the return is (outcome,
    per-tile violations, per-tile duplicate aliases), both int64 CPU
    tensors riding the same readback; a retry reads the exact artifact's
    output sum (and duplicate aliases) back once more."""
    head, viols, dups, r_flat, optimistic = _enqueue_build(
        rkeys, tile=tile, locality_window=locality_window, presort=presort,
        presorted=presorted, track=return_tile_violations)
    n_tiles = viols.numel()
    if return_tile_violations:
        head = torch.cat([head, viols, dups])
    bundle = head.cpu()
    resorted = False
    if optimistic and bundle[0] > 0:      # abort -> exact retry
        sorted_flat, _ = sort_tiles(r_flat, tile=tile, method="bitonic")
        again = _key_sum(sorted_flat).reshape(1)
        if return_tile_violations:
            again = torch.cat([again, _tile_dup_counts(sorted_flat, tile)])
        again = again.cpu()
        bundle[1] = again[0]
        if return_tile_violations:
            bundle[3 + n_tiles:] = again[1:]
        resorted = True
    out = BandedJoinOutcome(0, int(bundle[0]), 0, int(bundle[1]), resorted,
                            int(bundle[2]))
    if return_tile_violations:
        return out, bundle[3:3 + n_tiles], bundle[3 + n_tiles:]
    return out
