"""Multi-pass, fanout-bounded radix partitioning: the PRO pass machinery.

Counterpart of ``htm_hashjoin_tpu/ops/pallas/radix_kernels.py`` (the
reference's 2-pass parallel radix partition, parallel_radix_join.c:559-627
per pass and :869-956 for the pass structure; prj_params.h:15-22 for the
fanout bound).  A pass is restructured around sorted runs, as in the JAX
package:

  pass p =
    1. tile sort (K2, ``sort_tiles`` "bitonic"): within a sorted tile the
       pass-digit runs are contiguous;
    2. planning on (T, F) tables, in torch: per-tile digit boundaries by a
       batched searchsorted, destination rows by prefix sums (the
       histogram and cross-thread prefix sum of the reference);
    3. the scatter (K6, ``scatter_tiles``): every run to its rows.

Fanout contract: per-pass fanout F <= 128, and every intermediate pass's
output regions are padded to tile multiples so that the next pass sees
single-region tiles.  Region (= partition) f gets its runs rounded up to
whole 128-key rows, plus CH slack rows: the TPU kernel's chunked copies
need the slack; the Hopper kernel does not, but the layout (and so every
plan field and every output byte) is the JAX package's.

The output is value-ordered across partitions (MSB digits), so after the
last pass a plain tile sort gives the banded engine's build artifact, with
interspersed MAXI32 padding that every downstream kernel ignores.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from .scatter_tiles import MAX_FANOUT, scatter_tiles
from .sort_tiles import sort_tiles
from ..constants import LANES, MAXI32

CH = 16   # the TPU kernel's copy granule in rows (CH*128 = 2048 keys)


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# Planning: per-tile digit boundaries and destination tables
# ---------------------------------------------------------------------------

def tile_digit_bounds(sorted_flat: torch.Tensor, *, fanout: int, shift: int,
                      tile: int) -> torch.Tensor:
    """(T, F+1) int32: bounds[t, f] = the first key index in tile t whose
    pass digit is >= f (one batched binary search).  Valid because each
    sorted tile holds one region (value-monotone, so digit-monotone within
    the pass's bit window) and MAXI32 padding has digit F-1."""
    tiles = sorted_flat.view(-1, tile)
    digits = (tiles >> shift) & (fanout - 1)
    queries = torch.arange(fanout + 1, dtype=torch.int32,
                           device=tiles.device)
    queries = queries.expand(tiles.shape[0], fanout + 1).contiguous()
    return torch.searchsorted(digits, queries, side="left", out_int32=True)


class ScatterPlan(NamedTuple):
    a_elem: torch.Tensor       # (T, F) run start key index within its tile
    delta: torch.Tensor        # (T, F) the TPU kernel's staging shift (keys)
    dest_row: torch.Tensor     # (T, F) destination start row in the output
    n_chunks: torch.Tensor     # (T, F) the TPU kernel's CH-row copies
    hist: torch.Tensor         # (T, F) run sizes in keys (MAXI32 pads of
                               #        the tile count toward digit F-1)
    region_rows: torch.Tensor  # (R,) rows per output region (slack, align)
    out_rows: int              # static output row bound


def _scatter_plan(bounds, parent_of_tile, *, fanout: int, rows_per_tile: int,
                  align_tiles: bool, n_parents: int):
    """Destination bookkeeping from the per-tile digit bounds, in int64.

    Regions are (parent, digit) pairs, parent-major; the tiles of one
    parent are contiguous (the tile-alignment invariant), so per-region
    tile prefixes are global prefixes minus each parent's first-tile
    prefix.  The JAX function multiplies a one-hot parent matrix by the
    run rows; an ``index_add_`` over ``parent_of_tile`` is the same sum
    (torch has no int32 CUDA matmul)."""
    f = fanout
    b = bounds.to(torch.int64)
    hist = b[:, 1:] - b[:, :f]                      # (T, F)
    a_elem = b[:, :f]
    rows_tf = _cdiv(hist, LANES)                    # destination rows a run

    # the TPU kernel's staging layout: run f at the CH-quantised cumsum
    q_rows = _cdiv(rows_tf, CH) * CH
    q_start = torch.cumsum(q_rows, 1) - q_rows
    delta = q_start * LANES - a_elem

    parent = parent_of_tile.to(torch.int64)
    n_tiles = b.shape[0]
    region_sizes = torch.zeros((n_parents, f), dtype=torch.int64,
                               device=b.device).index_add_(0, parent, rows_tf)
    region_rows = region_sizes + torch.where(region_sizes > 0, CH, 0)
    if align_tiles:
        region_rows = _cdiv(region_rows, rows_per_tile) * rows_per_tile
    region_flat = region_rows.reshape(-1)           # parent-major
    region_base = torch.cumsum(region_flat, 0) - region_flat

    # (T, F) exclusive prefix down the tiles, scanned along the inner
    # dimension: torch's outer-dimension int64 scan took 22.7 ms for
    # 49,310 x 128 entries on an H100
    tile_prefix = rows_tf.t().contiguous().cumsum(1).t() - rows_tf
    tiles = torch.arange(n_tiles, dtype=torch.int64, device=b.device)
    first_tile = torch.zeros(n_parents, dtype=torch.int64,
                             device=b.device).scatter_reduce_(
        0, parent, tiles, "amin", include_self=False)
    within = tile_prefix - tile_prefix[first_tile][parent]
    dest_row = region_base.reshape(n_parents, f)[parent] + within
    n_chunks = _cdiv(rows_tf, CH)
    return tuple(x.to(torch.int32) for x in (a_elem, delta, dest_row,
                                             n_chunks, hist, region_flat))


def scatter_plan(bounds: torch.Tensor, parent_of_tile: torch.Tensor, *,
                 fanout: int, rows_per_tile: int, align_tiles: bool,
                 n_parents: int) -> ScatterPlan:
    """The plan of one pass.  The output is sized by the static worst case,
    as in the JAX package: every (tile, digit) run rounds up one row,
    every region takes CH slack (and tile alignment).  Trailing rows stay
    MAXI32 and flow to the top partition of later passes (padding is
    excluded everywhere downstream)."""
    t = bounds.shape[0]
    n_regions = n_parents * fanout
    out_rows = t * rows_per_tile + t * fanout + n_regions * CH
    if align_tiles:
        out_rows += n_regions * (rows_per_tile - 1)
    out_rows = _cdiv(out_rows, rows_per_tile) * rows_per_tile
    parts = _scatter_plan(bounds, parent_of_tile, fanout=fanout,
                          rows_per_tile=rows_per_tile,
                          align_tiles=align_tiles, n_parents=n_parents)
    return ScatterPlan(*parts, out_rows)


# ---------------------------------------------------------------------------
# Multi-pass driver
# ---------------------------------------------------------------------------

class RadixPassPlan(NamedTuple):
    shift: int
    bits: int


def plan_passes(key_bits: int, radix_bits: int, passes: int
                ) -> List[RadixPassPlan]:
    """Split the radix-bit budget across passes, MSB first (the NUM_PASSES
    structure, parallel_radix_join.c:869-956), each pass's fanout clamped
    to MAX_FANOUT; more bits than fit the pass budget add passes."""
    radix_bits = max(1, min(radix_bits, key_bits))
    per = _cdiv(radix_bits, max(1, passes))
    per = min(per, MAX_FANOUT.bit_length() - 1)
    plans = []
    used = 0
    while used < radix_bits:
        b = min(per, radix_bits - used)
        shift = key_bits - used - b
        plans.append(RadixPassPlan(shift=max(0, shift), bits=b))
        used += b
    return plans


class RadixPartitionResult(NamedTuple):
    partitioned: torch.Tensor          # (rows*128,) value-partitioned, MAXI32 pads
    pass_plans: List[RadixPassPlan]
    pass_hists: List[torch.Tensor]     # per-pass (T, F) run-size tables
    n: int                             # real key count


def _parents_from_regions(region_rows: torch.Tensor, *, n_tiles: int,
                          rows_per_tile: int) -> torch.Tensor:
    """The next pass's tile -> parent map from this pass's region rows
    (regions are tile-aligned, so each tile lies in exactly one; an empty
    region shares its start with its successor and the search resolves to
    the spanning one)."""
    rows = region_rows.to(torch.int64)
    starts = torch.cumsum(rows, 0) - rows
    tile_starts = torch.arange(n_tiles, dtype=torch.int64,
                               device=rows.device) * rows_per_tile
    return (torch.searchsorted(starts, tile_starts, side="right")
            - 1).to(torch.int32)


def _to_tiles(keys: torch.Tensor, tile: int) -> torch.Tensor:
    """MAXI32-pad to a tile multiple (at least one tile), flat."""
    n = keys.numel()
    pad = _cdiv(max(n, 1), tile) * tile - n
    if pad:
        keys = torch.cat([keys, torch.full((pad,), MAXI32, dtype=torch.int32,
                                           device=keys.device)])
    return keys.contiguous()


def multipass_radix_partition(keys: torch.Tensor, *, radix_bits: int = 14,
                              passes: int = 2, key_bits: int = 29,
                              tile: int = 8192) -> RadixPartitionResult:
    """Value-partition int32 keys into 2^radix_bits MSB ranges in
    ``passes`` fanout-bounded passes (K2 then K6 each).  The output is
    partition-contiguous (value-ordered) with interspersed MAXI32 row
    padding; a final tile sort turns it into the banded build artifact."""
    rows_per_tile = tile // LANES
    n = keys.numel()
    plans = plan_passes(key_bits, radix_bits, passes)
    cur = _to_tiles(keys, tile)
    n_tiles = cur.numel() // tile
    parent = torch.zeros(n_tiles, dtype=torch.int32, device=keys.device)
    n_parents = 1
    hists = []
    for i, p in enumerate(plans):
        fanout = 1 << p.bits
        sorted_flat, _ = sort_tiles(cur, tile=tile, method="bitonic")
        bounds = tile_digit_bounds(sorted_flat, fanout=fanout, shift=p.shift,
                                   tile=tile)
        align = i + 1 < len(plans)          # intermediate regions tile-aligned
        plan = scatter_plan(bounds, parent, fanout=fanout,
                            rows_per_tile=rows_per_tile, align_tiles=align,
                            n_parents=n_parents)
        del bounds
        cur = scatter_tiles(sorted_flat, plan.a_elem, plan.dest_row,
                            tile=tile, out_rows=plan.out_rows)
        del sorted_flat
        hists.append(plan.hist)
        n_tiles = cur.numel() // tile
        n_parents *= fanout                 # region ids are parent-major
        if align:
            parent = _parents_from_regions(plan.region_rows, n_tiles=n_tiles,
                                           rows_per_tile=rows_per_tile)
    return RadixPartitionResult(cur, plans, hists, n)
