"""Joiner policy lattice — mc/wisconsin-src/algo/* on tensors.

Counterpart of ``htm_hashjoin_tpu/wisconsin/joiners.py``.  The reference
composes joiners from policy mixins (joinerfactory.cpp:23-75):
``{StoreCopy,StorePointer} × {BuildIsPart,BuildIsNotPart} ×
{ProbeIsPart,ProbeIsNotPart,ProbeSteal}`` plus two specials (NestedLoops,
FlatMemoryJoiner).  Each axis exists to manage CPU concurrency and cache
locality; here:

  storage axis (storage.cpp StoreCopy vs storagepl.cpp StorePointer)
      StoreCopy gathers the payload columns into build order at build time
      (early materialization); StorePointer keeps only the row permutation
      and gathers payload at emit (late materialization).

  build axis (build.inl)
      Every build is conflict-free by construction: the chained bucket
      pages (hashtable.h:24-50) become a key-sorted layout.  BuildIsPart
      records the co-partitioning that lets a scheduled probe search only
      its own build partition.

  probe axis (probe.inl)
      ProbeIsPart / ProbeSteal run as <= nthreads worker blocks with
      measured per-worker spans (``HashJoiner._scheduled_probe``);
      ProbeIsNotPart runs the whole probe at once.

  match kernel
      Bucket-chain walks become match ranges [lo, hi) of each probe key in
      the key-sorted build side, from a dense rank directory, arithmetic
      under a permutation-build certificate, or binary searches.

Outputs are materialized (schema = select1 cols ++ select2 cols, the
OUTPUT_ASSEMBLE path of flatmem.cpp/storage.cpp), not just counted, at a
capacity rounded to the next power of two, as in the JAX package.  No
kernel of this module is a port of a Pallas kernel: the JAX module's are
XLA programs, and their counterparts here are torch ops, but for one
route on the card: a partitioned probe (ProbeIsPart) of a StoreCopy
permutation build over int32 columns runs each worker block's probe and
emit as one launch of ``ops/multijoin_probe.py``'s kernel
(``HashJoiner._kernel_probe``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.multijoin_probe import multijoin_probe, new_heads
from ..relation import next_pow2
from ..utils.profiler import span, sync_stats
from ..utils.timing import readback, readback_array
from .hashfn import HashFunction
from .partitioner import PartitionedTable, RadixPartitioner
from .schema import Schema
from .table import Table, host, is_strings


def _arange(n: int, like: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=like.device)


def _take(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """col[idx] for an int32 or int64 index (no int64 copy of an int32
    index: at a 2^28-row emit that copy is 2 GB)."""
    return torch.index_select(col, 0, idx)


def _gather(col, idx: torch.Tensor):
    """col[idx]: on the device for a tensor column, on the host for a
    string column."""
    if is_strings(col):
        return col[host(idx)]
    return col[idx]


def _pad_to(x: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((cap - x.shape[0],))])


def _upload(array, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``.  On the card the copy leaves from pinned
    memory and the host does not wait: a copy from pageable memory would
    synchronize the stream, a wait on the device's queued work."""
    t = torch.as_tensor(array)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


#: worker blocks whose probe and emit ran ``multijoin_probe`` and whose
#: output the probe kept (``HashJoiner._kernel_probe``)
PROBE_KERNEL_BLOCKS = 0


def _on_card(keys: torch.Tensor) -> bool:
    """The probe kernel's device gate: the keys lie on a CUDA device."""
    return keys.is_cuda


# ---------------------------------------------------------------------------
# Join-index kernels
# ---------------------------------------------------------------------------

def _expand_matches(lo: torch.Tensor, hi: torch.Tensor, cap: int):
    """Expand per-probe match ranges [lo, hi) into flat (probe_row,
    build_rank) index pairs of static length ``cap``.

    For output slot k: its probe row is the last i with offsets[i] <= k, and
    its match ordinal is k - offsets[i].  Invalid slots (k >= total) get
    index -1.  This replaces the reference's per-thread output cursors
    (WriteTable::append, table.h:200-253).  The JAX function finds each
    slot's owner with a scatter-max and a cummax; here one binary search
    per slot gives the same owner (torch's cummax is slow on the card)."""
    idt = torch.int32 if cap < (1 << 31) else torch.int64
    counts = (hi - lo).to(idt)
    offsets = torch.cat([counts.new_zeros((1,)),
                         torch.cumsum(counts, 0, dtype=idt)])
    total = readback(offsets[-1])
    k = _arange(cap, lo, idt)
    if lo.shape[0] == 0:
        none = torch.full((cap,), -1, dtype=idt, device=lo.device)
        return none, none.clone(), 0
    starts = offsets[:-1].contiguous()
    pi = (torch.searchsorted(starts, k, right=True,
                             out_int32=idt == torch.int32) - 1).clamp_(min=0)
    base = lo.to(idt) - starts
    build_rank = k + _take(base, pi)
    valid = k < total
    probe_idx = torch.where(valid, pi.to(idt), -1)
    build_rank = torch.where(valid, build_rank, -1)
    return probe_idx, build_rank, total


def _match_bounds_tagged(sorted_keys: torch.Tensor, probe_keys: torch.Tensor,
                         comp_dtype):
    """Match ranges [lo, hi) of each probe key in the key-sorted build side
    — the bucket-chain walk analog (storage.cpp realprobeCursor;
    hashtable.h iterator).

    The JAX function sorts a tagged (key·2+side, row) stream: at a probe
    element's position the running build count is hi(key), and the count
    at its key-run start is lo(key).  Those are the right and left
    insertion points of the key in the sorted build side, which two binary
    searches give directly.  ``comp_dtype`` is the composite's dtype (int32
    when every |key| is certified < 2^30, else int64): both sides are
    searched in it, so routes and pad sentinels keep their dtypes."""
    b = sorted_keys.to(comp_dtype)
    p = probe_keys.to(sorted_keys.dtype).to(comp_dtype)
    lo = torch.searchsorted(b, p, out_int32=True)
    hi = torch.searchsorted(b, p, right=True, out_int32=True)
    total = (hi - lo).sum(dtype=torch.int64)
    return lo, hi, total


def _keys_absmax(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max |key| over both sides in one readback: the int32 composite's
    certificate."""
    m = torch.stack([torch.maximum(a.max(), b.max()).long(),
                     -torch.minimum(a.min(), b.min()).long()])
    return readback(m.max())


_I32_COMP_LIMIT = (1 << 30) - 1  # |key|*2+1 must stay in int32, with one
# value spare at each end for the schedule pads below (a probe pad must
# sort strictly below, and a build-slice pad strictly above, every
# certified key — at exactly 2^30-1 the pad composite would collide)

# Schedule padding sentinels: probe pads sort below / match nothing; build
# pads sort above every certified real key (see _block_bounds_local).
_PAD_PROBE_I32 = -((1 << 30) - 1)
_PAD_BUILD_I32 = (1 << 30) - 1
_PAD_PROBE_I64 = -((1 << 62) - 1)
_PAD_BUILD_I64 = (1 << 62) - 1

# Dense-key rank table: eligible when build keys lie in [0, K] with K small
# enough that a (K+1)-entry table is cheap (≤ 16x the build side and ≤ 2^26
# entries).  The canonical multijoin workloads qualify: 16M build keys
# drawn 1..16M (wisconsin-src/datagen/genbuild.py).
_DENSE_LIMIT = 1 << 26

# The local route's pad bound: a scheduled probe takes "local" only when
# both its (units, probe pad) and its (units, build pad) matrices stay
# within this many elements (the JAX gate bounds the probe side only).
_LOCAL_PAD_LIMIT = 1 << 27


def _count_into(n_bins: int, idx: torch.Tensor) -> torch.Tensor:
    """int32 histogram of ``idx`` over [0, n_bins), as JAX's
    ``.at[idx].add(1, mode="drop")`` counts: an index in [-n_bins, 0)
    wraps to idx + n_bins, any other outside index is dropped."""
    idx = torch.where(idx < 0, idx + n_bins, idx)
    ok = (idx >= 0) & (idx < n_bins)
    slot = torch.where(ok, idx, n_bins).long()
    cnt = torch.zeros((n_bins + 1,), dtype=torch.int32, device=idx.device)
    cnt.index_add_(0, slot, torch.ones_like(idx, dtype=torch.int32))
    return cnt[:n_bins]


def _dense_rank_table(keys: torch.Tensor, tbl_len: int):
    """Per-key bounds directory over the key-sorted build order: cnt[k] =
    multiplicity of key k, cum[k] = #build keys <= k — so lo = cum-cnt,
    hi = cum index the sorted build side.  Two int32 tables of
    ``tbl_len`` entries."""
    cnt = _count_into(tbl_len, keys)
    cum = torch.cumsum(cnt, 0, dtype=torch.int32)
    return cum, cnt, cnt.max()


def _dense_bounds(cum: torch.Tensor, cnt_tbl: torch.Tensor,
                  probe_keys: torch.Tensor):
    """Match ranges via two int32 gathers from the dense rank directory —
    no sort, no scatter.  Out-of-range probe keys match nothing.  Returns
    (lo, hi, [total, all_unit]); all_unit certifies every probe count == 1
    (the FK fast path: expansion becomes the identity)."""
    k_max = cum.shape[0] - 1
    idx = probe_keys.clamp(0, k_max).to(torch.int32)
    valid = (probe_keys >= 0) & (probe_keys <= k_max)
    cnt = torch.where(valid, _take(cnt_tbl, idx), 0)
    hi = torch.where(valid, _take(cum, idx), 0)
    lo = hi - cnt
    total = cnt.sum(dtype=torch.int64)
    # negative keys are schedule padding (matches nothing) — they do not
    # void the unit certificate; generated keys are 1-based so a real
    # non-matching key (cnt 0, key >= 0) still voids it
    all_unit = ((cnt == 1) | (probe_keys < 0)).all().long()
    return lo, hi, torch.stack([total, all_unit])


def _dense_bounds_perm(probe_keys: torch.Tensor, kmin: int, kmax: int):
    """Bounds under the PERMUTATION-BUILD certificate (dense keys covering
    [kmin, kmax] exactly once — the canonical 16M PK build): lo is pure
    arithmetic, no table, no gather.  head = [total, all_unit]; a probe key
    outside the range voids all_unit and the caller falls back to the
    gather-based directory for exact hi/lo of the non-matching rows."""
    valid = (probe_keys >= kmin) & (probe_keys <= kmax)
    lo = torch.where(valid, probe_keys - kmin, 0).to(torch.int32)
    hi = lo + valid.to(torch.int32)
    total = valid.sum(dtype=torch.int64)
    all_unit = (valid | (probe_keys < 0)).all().long()
    return lo, hi, torch.stack([total, all_unit])


def _flat_directory(keys_flat_order: torch.Tensor, tbl_len: int):
    """Start/count directory over the keyspace for a FLAT-ORDER build
    (FlatMemoryJoiner): start_tbl[k] = first flat position of key k,
    cnt_tbl[k] = multiplicity.  Valid because equal keys are contiguous in
    (bucket, key) order when bucket = hash(key)."""
    n = keys_flat_order.shape[0]
    pos = _arange(n, keys_flat_order)
    ok = (keys_flat_order >= 0) & (keys_flat_order < tbl_len)
    slot = torch.where(ok, keys_flat_order, tbl_len).long()
    start = torch.full((tbl_len + 1,), n, dtype=torch.int32,
                       device=keys_flat_order.device)
    start.scatter_reduce_(0, slot, pos, reduce="amin")
    return start[:tbl_len], _count_into(tbl_len, keys_flat_order)


def _flat_dense_bounds(start_tbl: torch.Tensor, cnt_tbl: torch.Tensor,
                       probe_keys: torch.Tensor):
    """Flat-order match ranges via two int32 gathers (see _dense_bounds;
    same head = [total, pad-aware all_unit] contract)."""
    k_max = start_tbl.shape[0] - 1
    idx = probe_keys.clamp(0, k_max).to(torch.int32)
    valid = (probe_keys >= 0) & (probe_keys <= k_max)
    cnt = torch.where(valid, _take(cnt_tbl, idx), 0)
    lo = torch.where(valid & (cnt > 0), _take(start_tbl, idx), 0)
    hi = lo + cnt
    total = cnt.sum(dtype=torch.int64)
    all_unit = ((cnt == 1) | (probe_keys < 0)).all().long()
    return lo, hi, torch.stack([total, all_unit])


def _steal_cuts(occ: torch.Tensor, buckets: torch.Tensor, k: int,
                use_i32: bool = False):
    """ProbeSteal's cost-balanced cut points, computed on the device: only
    the k-1 cut rows and the k chunk costs come back.

    ``use_i32``: the caller certifies n_probe * (max_occupancy + 1) <
    2^31, so the whole cost prefix fits int32."""
    dt = torch.int32 if use_i32 else torch.int64
    cost = _take(occ, buckets).to(dt) + 1
    prefix = torch.cumsum(cost, 0, dtype=dt)
    total = prefix[-1].long()
    targets = torch.div(torch.arange(1, k, dtype=torch.int64,
                                     device=occ.device) * total, k,
                        rounding_mode="floor").to(dt)
    cuts = torch.searchsorted(prefix, targets).long()
    n = buckets.shape[0]
    bounds = torch.cat([cuts.new_zeros((1,)), cuts, cuts.new_full((1,), n)])
    cprefix = torch.cat([prefix.new_zeros((1,)), prefix]).long()
    balance = cprefix[bounds[1:]] - cprefix[bounds[:-1]]
    return bounds, balance


def _partition_costs(lo, hi, starts, ends):
    counts = (hi - lo).long() + 1
    cum = torch.cat([counts.new_zeros((1,)), torch.cumsum(counts, 0)])
    return cum[ends] - cum[starts]


def _build_key_stats(keys: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """[max bucket occupancy, min key, max key] in ONE readback."""
    return torch.stack([occ.max().long(), keys.min().long(),
                        keys.max().long()])


def _match_bounds(sorted_keys: torch.Tensor, probe_keys: torch.Tensor,
                  key_bound: Optional[int] = None):
    """Dtype-routing wrapper: int32 composite when |key| is certified
    < 2^30 (the composite key*2+tag is order-preserving in int32 there —
    negative keys included), int64 otherwise.  Pass ``key_bound`` = max
    |key| to skip the certification readback."""
    if key_bound is None:
        if (not sorted_keys.dtype.is_floating_point
                and sorted_keys.element_size() <= 4
                and probe_keys.element_size() <= 4
                and sorted_keys.numel() and probe_keys.numel()):
            key_bound = _keys_absmax(sorted_keys, probe_keys)
        else:
            key_bound = _I32_COMP_LIMIT
    dt = torch.int32 if key_bound < _I32_COMP_LIMIT else torch.int64
    return _match_bounds_tagged(sorted_keys, probe_keys, dt)


# ---------------------------------------------------------------------------
# Worker-block probe programs (the scheduled-probe engine)
#
# A scheduled probe (ProbeIsPart / ProbeSteal) decomposes the probe into
# units; units are grouped into <= nthreads CONTIGUOUS row-balanced blocks,
# one per worker, and each worker's whole block is enqueued as one chain of
# device work.  Per-unit totals come from a boundary cumsum inside the
# block, so the measured per-unit schedule survives with one readback for
# all the workers.
# ---------------------------------------------------------------------------

def _unit_totals(lo, hi, ubounds):
    """Per-unit match totals from flat per-row bounds: one cumsum + a
    gather at the unit boundaries (ubounds = U+1 row offsets, clamped)."""
    counts = (hi - lo).long()
    cum = torch.cat([counts.new_zeros((1,)), torch.cumsum(counts, 0)])
    return cum[ubounds[1:]] - cum[ubounds[:-1]]


def _block_bounds_perm(W: int, pk_pad, start: int, ubounds, kmin, kmax):
    """Worker block under the permutation-build certificate: bounds are
    pure arithmetic (no table, no gather)."""
    seg = pk_pad[start:start + W]
    lo, hi, head = _dense_bounds_perm(seg, kmin, kmax)
    return lo, hi, torch.cat([_unit_totals(lo, hi, ubounds), head])


def _block_bounds_dense(W: int, pk_pad, start: int, ubounds, cum, cnt_tbl):
    """Worker block over the dense rank directory (two int32 gathers per
    row)."""
    seg = pk_pad[start:start + W]
    lo, hi, head = _dense_bounds(cum, cnt_tbl, seg)
    return lo, hi, torch.cat([_unit_totals(lo, hi, ubounds), head])


def _block_bounds_sorted(W: int, use_i32: bool, pk_pad, start: int, ubounds,
                         sorted_keys):
    """Worker block against the full key-sorted build (the
    ProbeIsNotPart-style search, used when the probe decomposition is not
    co-partitioned with the build)."""
    seg = pk_pad[start:start + W]
    dt = torch.int32 if use_i32 else torch.int64
    lo, hi, t = _match_bounds_tagged(sorted_keys, seg, dt)
    head = torch.stack([t, t.new_zeros(())])
    return lo, hi, torch.cat([_unit_totals(lo, hi, ubounds), head])


def _block_bounds_local(W: int, U: int, BP: int, PP: int, use_i32: bool,
                        pk_pad, start: int, ubounds, bkeys_ps, b0, blen,
                        g_of_l):
    """Partition-LOCAL worker block: probe unit u searches ONLY build
    partition u's slice (probe.inl:18-36).

    The build side is sorted by (partition, key) (`bkeys_ps`); unit u's
    slice starts at b0[u] with blen[u] rows, padded to BP with a sentinel
    that sorts above every certified key.  A batched search computes
    slice-local bounds; local ranks map to GLOBAL key-sorted ranks through
    ``g_of_l`` (global rank of each part-sorted row) — valid because both
    sorts are stable and equal keys share one partition under the
    co-partitioning certificate, so a key's run maps monotonically."""
    # matrices live in the COMPOSITE dtype so the pad sentinels always
    # sit strictly outside the certified key domain
    dt = torch.int32 if use_i32 else torch.int64
    pad_b = _PAD_BUILD_I32 if use_i32 else _PAD_BUILD_I64
    pad_p = _PAD_PROBE_I32 if use_i32 else _PAD_PROBE_I64
    dev = pk_pad.device
    seg = pk_pad[start:start + W]
    ub0 = ubounds[:-1]
    ulen = ubounds[1:] - ubounds[:-1]
    j = torch.arange(PP, dtype=torch.int64, device=dev)
    pvalid = j[None, :] < ulen[:, None]
    pidx = torch.clamp(ub0[:, None] + j[None, :], max=W - 1)
    pmat = torch.where(pvalid, seg[pidx].to(dt), pad_p)
    i = torch.arange(BP, dtype=torch.int64, device=dev)
    nb = bkeys_ps.shape[0]
    bvalid = i[None, :] < blen[:, None]
    bidx = torch.clamp(b0[:, None] + i[None, :], max=max(0, nb - 1))
    bmat = torch.where(bvalid, bkeys_ps[bidx].to(dt), pad_b)
    lo_l = torch.searchsorted(bmat, pmat, out_int32=True)
    hi_l = torch.searchsorted(bmat, pmat, right=True, out_int32=True)
    cnt = hi_l - lo_l
    gidx = torch.clamp(b0[:, None] + lo_l, max=max(0, nb - 1))
    lo_g = torch.where(cnt > 0, g_of_l[gidx], 0).to(torch.int32)
    hi_g = lo_g + cnt
    # scatter the (U, PP) unit matrices back to the flat (W,) block layout
    flat_pos = torch.where(pvalid, ub0[:, None] + j[None, :], W).reshape(-1)
    lo = torch.zeros((W + 1,), dtype=torch.int32, device=dev)
    hi = torch.zeros((W + 1,), dtype=torch.int32, device=dev)
    lo[flat_pos] = lo_g.reshape(-1)
    hi[flat_pos] = hi_g.reshape(-1)
    lo, hi = lo[:W], hi[:W]
    total = torch.where(pvalid, cnt, 0).sum(dtype=torch.int64)
    all_unit = ((cnt == 1) | ~pvalid).all().long()
    return lo, hi, torch.cat([_unit_totals(lo, hi, ubounds),
                              torch.stack([total, all_unit])])


def _block_ubounds(units, ulo: int, uhi: int, U: int):
    """A worker block's first row and its units' U + 1 row offsets from
    it, padded with the block's row count past its last unit."""
    a0 = units[ulo][0]
    ub = np.full((U + 1,), units[uhi - 1][1] - a0, np.int64)
    ub[:uhi - ulo + 1] = [units[i][0] - a0 for i in range(ulo, uhi)] + \
        [units[uhi - 1][1] - a0]
    return a0, ub


def _balance_unit_blocks(units, k: int):
    """Group the ordered units into <= k contiguous blocks with ~equal row
    counts — the static owner schedule (each worker ends up with ~1/k of
    the probe rows, what the reference's per-thread partition walk
    converges to; SURVEY.md §2.4 P8)."""
    n_units = len(units)
    if n_units <= k:
        return [(i, i + 1) for i in range(n_units)]
    rows = np.array([b - a for a, b in units], np.int64)
    cum = np.concatenate([[0], np.cumsum(rows)])
    total = int(cum[-1])
    cuts = [0]
    for w in range(1, k):
        t = w * total // k
        j = int(np.searchsorted(cum, t))
        cuts.append(min(max(j, cuts[-1] + 1), n_units - (k - w)))
    cuts.append(n_units)
    return [(a, b) for a, b in zip(cuts[:-1], cuts[1:]) if b > a]


def _part_sorted_build(keys_part_order: torch.Tensor, offsets):
    """(partition, key)-sorted build layout + the local->global rank map.

    keys arrive grouped by partition (the split's layout); each row's
    partition is the last p with offsets[p] <= row (one binary search per
    row; the JAX function's scatter-max + cummax finds the same p).
    Returns (bkeys_ps, g_of_l): the part-sorted keys and, for each
    part-sorted position, its rank in the GLOBAL key sort."""
    n = keys_part_order.shape[0]
    dev = keys_part_order.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    pid = torch.searchsorted(offsets, rows, right=True) - 1
    # (pid, key, original pos) lexicographic order via two STABLE argsorts
    order_g = torch.argsort(keys_part_order, stable=True)
    order_p = order_g[torch.argsort(pid[order_g], stable=True)]
    bkeys_ps = keys_part_order[order_p]
    inv_g = torch.empty((n,), dtype=torch.int32, device=dev)
    inv_g[order_g] = torch.arange(n, dtype=torch.int32, device=dev)
    return bkeys_ps, inv_g[order_p]


class _Mark:
    """A point in a device stream's progress: a CUDA event on CUDA tensors,
    the host clock on CPU ones (where work is done when its call returns)."""

    def __init__(self, dev: torch.device):
        self.event = None
        if dev.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record(torch.cuda.current_stream(dev))
        else:
            self.t = time.perf_counter()

    def micros_since(self, other: "_Mark") -> float:
        if self.event is not None:
            return other.event.elapsed_time(self.event) * 1e3
        return (self.t - other.t) * 1e6


# ---------------------------------------------------------------------------
# Base joiner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JoinStats:
    """Observable policy effects (the reference's per-phase instrumentation,
    main.cpp:75-94)."""

    build_rows: int = 0
    probe_rows: int = 0
    output_rows: int = 0
    bucket_count: int = 0
    max_bucket_occupancy: int = 0
    partition_probe_costs: Optional[np.ndarray] = None
    stolen_balance: Optional[np.ndarray] = None  # ProbeSteal static plan
    probe_schedule: Optional[dict] = None  # MEASURED per-unit schedule:
    # {policy, route, units: [(start_row, rows, micros)], worker_micros,
    #  imbalance} — the execution difference between ProbeIsPart and
    #  ProbeSteal (probe.inl:18-52), see HashJoiner._scheduled_probe


class BaseJoiner:
    """BaseAlgo analog (algo/algo.h:32-58): init copies schemas/selects,
    build consumes the build-side split, probe returns the output table."""

    def __init__(self, hashfn: Optional[HashFunction] = None,
                 output_page_size: int = 1 << 20):
        self.hashfn = hashfn
        self.output_page_size = output_page_size
        self.stats = JoinStats()

    def init(self, schema1: Schema, select1: Sequence[int], jattr1: int,
             schema2: Schema, select2: Sequence[int], jattr2: int) -> None:
        self.s1, self.s2 = schema1, schema2
        self.sel1, self.sel2 = list(select1), list(select2)
        self.ja1, self.ja2 = jattr1, jattr2
        self.sout = Schema(schema1.project(self.sel1).types
                           + schema2.project(self.sel2).types)
        # sbuild = {key, selected payload} (algo.h:38-44)
        self.sbuild = schema1.build_schema(self.sel1, jattr1)

    def build(self, parts: PartitionedTable) -> None:
        raise NotImplementedError

    def probe(self, parts: PartitionedTable) -> Table:
        raise NotImplementedError

    # -- shared emit ---------------------------------------------------------

    def _emit(self, probe_table: Table, lo, hi, total: int,
              build_payload_cols: List,
              unit_counts: bool = False) -> Table:
        """Materialize output rows: sel1 payload gathered from the build
        structure, sel2 columns gathered from the probe side.

        Numeric output columns are gathered on the device and stay there,
        at a next-pow2 capacity with the invalid tail beyond ``rows``
        (slots k >= total are exactly the tail, _expand_matches); string
        columns gather on the host over the valid prefix."""
        total_i = int(total)
        cap = max(8, next_pow2(total_i))
        # every probe row matches exactly once (the FK invariant, certified
        # on the device by the bounds pass, where a negative key matches
        # nothing and does not void it: hence the count): expansion is the
        # identity, and b_rank IS lo end-padded
        identity = bool(unit_counts and total_i and total_i == lo.shape[0])
        if identity:
            k = _arange(cap, lo)
            p_idx = torch.where(k < total_i,
                                torch.clamp(k, max=total_i - 1), 0)
            b_rank = _pad_to(lo, cap)
        else:
            probe_idx, build_rank, _ = _expand_matches(lo, hi, cap)
            b_rank = torch.clamp(build_rank, min=0)
            p_idx = torch.clamp(probe_idx, min=0)
        out_cols: List = []
        for col in build_payload_cols:
            if is_strings(col):
                out_cols.append(col[host(b_rank[:total_i])])
            elif not col.numel():    # an empty side: nothing to gather
                out_cols.append(col.new_zeros((cap,)))
            else:
                out_cols.append(_take(col, b_rank))
        for c in self.sel2:
            col = probe_table.column(c)
            if is_strings(col):
                out_cols.append(col[host(p_idx[:total_i])])
            elif not col.numel():
                out_cols.append(col.new_zeros((cap,)))
            elif identity:
                # all-unit FK emit: p_idx is the identity, so the probe
                # column IS the output column — no 2^28-element gather
                out_cols.append(_pad_to(col, cap))
            else:
                out_cols.append(_take(col, p_idx))
        self.stats.output_rows = total_i
        return Table(self.sout, out_cols, self.output_page_size,
                     rows=total_i)


# ---------------------------------------------------------------------------
# The hash-join policy lattice
# ---------------------------------------------------------------------------

class HashJoiner(BaseJoiner):
    """The {storage × build × probe} lattice in one composable class.

    ``storage``: 'copy' (StoreCopy, storage.cpp) or 'pointer'
    (StorePointer, storagepl.cpp).  ``partition_build``/``partition_probe``/
    ``steal`` select the build.inl/probe.inl mixins.
    """

    def __init__(self, hashfn: HashFunction, *, storage: str = "copy",
                 partition_build: bool = False, partition_probe: bool = False,
                 steal: bool = False, output_page_size: int = 1 << 20,
                 build_page_size: int = 32, nthreads: int = 1):
        super().__init__(hashfn, output_page_size)
        self.nthreads = max(1, int(nthreads))
        if steal and partition_build:
            raise ValueError("steal requires partitionbuild == no "
                             "(joinerfactory.cpp:39-41 asserts)")
        self.storage = storage
        self.partition_build = partition_build
        self.partition_probe = partition_probe
        self.steal = steal
        self.build_page_size = build_page_size  # conf 'buildpagesize'

    # -- build ---------------------------------------------------------------

    def build(self, parts: PartitionedTable) -> None:
        """Construct the key-sorted table.

        BuildIsPart (build.inl:18-25) and BuildIsNotPart (build.inl:27-32)
        are both one conflict-free sort; they differ in which precondition
        they rely on (hash-partition ⇒ disjoint buckets) and in the layout
        stats recorded."""
        table = parts.table
        keys = table.key_column(self.ja1)
        buckets = self.hashfn.hash(keys)
        occ = _count_into(self.hashfn.buckets, buckets)
        self._bucket_occ = occ        # ProbeSteal's cost model (see probe)
        self.stats.build_rows = table.num_rows
        self.stats.bucket_count = self.hashfn.buckets
        self._dense_tbl = None
        self._perm_build = False
        self._key_bound = _I32_COMP_LIMIT
        if table.num_rows:
            max_occ, kmin, kmax = readback(_build_key_stats(keys, occ))
            self.stats.max_bucket_occupancy = max_occ
            self._key_bound = max(abs(kmin), abs(kmax))
            if keys.element_size() > 4 and self._key_bound < (1 << 31):
                keys = keys.to(torch.int32)   # half the bytes to sort
            if (0 <= kmin and kmax < _DENSE_LIMIT
                    and kmax < max(16 * table.num_rows, 1 << 20)):
                cum, cnt, mx_cnt = _dense_rank_table(keys,
                                                     next_pow2(kmax + 2))
                self._dense_tbl = (cum, cnt)
                # permutation certificate: every key in [kmin, kmax]
                # appears exactly once -> probe bounds are arithmetic
                self._kmin, self._kmax = kmin, kmax
                self._perm_build = (readback(mx_cnt) == 1
                                    and kmax - kmin + 1 == table.num_rows)
        else:
            self.stats.max_bucket_occupancy = 0
        order = torch.argsort(keys, stable=True)
        self._build_keys_sorted = keys[order]
        self._build_perm = order               # StorePointer: the "pointers"
        self._build_table = table
        # co-partitioning metadata for partition-LOCAL probes: when the
        # probe side is split by the same hash on the join attribute,
        # probe unit p searches only build partition p (probe.inl:18-36)
        self._build_parts_meta = None
        self._plocal = None
        if parts.nparts > 1 and parts.part_hash is not None:
            self._build_parts_meta = (
                parts.part_hash, parts.part_attr,
                np.asarray(parts.offsets, np.int64),
                np.asarray(parts.sizes, np.int64))
        if self.storage == "copy":
            # early materialization: gather payload columns into build order
            # (numeric on the device, strings on the host)
            self._build_payload = [_gather(table.column(c), order)
                                   for c in self.sel1]
        else:
            self._build_payload = None

    # -- probe ---------------------------------------------------------------

    def _bounds(self, probe_keys):
        """Match-range route: arithmetic under the permutation certificate,
        the dense rank table when the build certified a dense key range,
        binary searches otherwise.  Returns (lo, hi, total, all_unit) with
        one readback."""
        if self._dense_tbl is not None:
            if self._perm_build:
                lo, hi, head = _dense_bounds_perm(probe_keys, self._kmin,
                                                  self._kmax)
                tot, unit = readback(head)
                if unit:          # every probe key in range
                    return lo, hi, tot, True
            lo, hi, head = _dense_bounds(*self._dense_tbl, probe_keys)
            tot, unit = readback(head)
            return lo, hi, tot, bool(unit)
        lo, hi, t = _match_bounds(self._build_keys_sorted, probe_keys)
        return lo, hi, readback(t), False

    def _schedule_bounds(self, parts: PartitionedTable, probe_keys,
                         n: int) -> "tuple[np.ndarray, str]":
        """Row-range decomposition of the probe under the policy.

        ProbeIsPart (probe.inl:18-36): one unit per partition, owner order.
        ProbeSteal (probe.inl:37-52): nthreads equal-COST contiguous
        chunks, cut by the bucket-occupancy cost model — the static
        schedule the reference's dynamic stealing converges to."""
        if self.steal:
            use_i32 = (n * (self.stats.max_bucket_occupancy + 1)
                       < (1 << 31))
            bounds_d, balance_d = _steal_cuts(
                self._bucket_occ, self.hashfn.hash(probe_keys),
                self.nthreads, use_i32)
            bb = host(torch.cat([bounds_d, balance_d]))  # ONE readback
            k1 = self.nthreads + 1
            self.stats.stolen_balance = bb[k1:]
            return np.unique(bb[:k1]), "probe_steal"
        bounds = np.concatenate([np.asarray(parts.offsets, np.int64), [n]])
        return np.unique(bounds), "probe_is_part"

    def _probe_route(self, parts: PartitionedTable, units, policy: str):
        """Pick the bounds route for a scheduled probe, cheapest first:
        'perm' (arithmetic, permutation-build certificate), 'dense' (rank
        directory gathers), 'local' (co-partitioned build: unit p searches
        ONLY build partition p's slice), 'sorted' (full-build search per
        worker — the ProbeIsNotPart-style search)."""
        if self._perm_build:
            return "perm"
        if self._dense_tbl is not None:
            return "dense"
        meta = self._build_parts_meta
        if (policy == "probe_is_part"   # steal chunks cross partitions
                and meta is not None and parts.part_hash is not None
                and parts.part_hash == meta[0]
                and parts.part_attr == self.ja2 and meta[1] == self.ja1
                and parts.nparts == len(meta[3])):
            # co-partitioned: same hash fingerprint on both join attrs.
            # Guard BOTH unit matrices against skew — the probe pad (one
            # unit ~ the whole probe) and the build pad (one build
            # partition ~ the whole build; the JAX gate misses this one):
            # fall back to 'sorted' before materializing a quadratic pad
            max_unit = max(b - a for a, b in units)
            max_part = int(meta[3].max())
            if (len(units) * next_pow2(max_unit) <= _LOCAL_PAD_LIMIT
                    and len(units) * next_pow2(max_part)
                    <= _LOCAL_PAD_LIMIT):
                return "local"
        return "sorted"

    def _plocal_arrays(self):
        """Lazy (partition, key)-sorted build layout for the local route
        (built once; the reference's BuildIsPart private tables are
        likewise per-partition artifacts of the build phase)."""
        if self._plocal is None:
            _, _, offs, _ = self._build_parts_meta
            keys_po = self._build_table.key_column(self.ja1).to(
                self._build_keys_sorted.dtype)
            self._plocal = _part_sorted_build(
                keys_po, _upload(offs, keys_po.device))
        return self._plocal

    def _schedule(self, parts: PartitionedTable, probe_keys, n: int):
        """A scheduled probe's plan: (policy, units, blocks, route, U).  The
        units are row ranges of the probe (``_schedule_bounds``), grouped
        into <= nthreads contiguous row-balanced worker blocks of at most
        U units, and the route is the bounds route (``_probe_route``)."""
        bounds, policy = self._schedule_bounds(parts, probe_keys, n)
        units = [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])
                 if b > a]
        blocks = _balance_unit_blocks(units, self.nthreads)
        route = self._probe_route(parts, units, policy)
        return policy, units, blocks, route, max(b - a for a, b in blocks)

    def _record_schedule(self, plan, heads, origin: _Mark, marks):
        """The measured schedule from the blocks' heads (their U unit
        totals, then [total, all_unit]) and their completion marks: sets
        ``_last_unit_totals`` and ``stats.probe_schedule``; returns (total,
        all_unit).  Worker spans are the measured completion deltas of the
        device-serialized blocks — the per-thread rdtsc span analog
        (main.cpp:75-94); per-unit micros apportion each worker's span by
        unit rows.  An ``hj.schedule`` span: the card waits on it."""
        policy, units, blocks, route, U = plan
        with span("hj.schedule"):
            times = [0.0] * len(units)
            worker_us = [0.0] * self.nthreads
            unit_totals = np.zeros((len(units),), np.int64)
            total = 0
            all_unit = True
            prev = origin
            for w, ((ulo, uhi), hd, mark) in enumerate(zip(blocks, heads,
                                                           marks)):
                worker_us[w] = mark.micros_since(prev)
                prev = mark
                unit_totals[ulo:uhi] = hd[:uhi - ulo]
                # the block's W-row window may overlap the next block's rows
                # (shared shape) — the boundary-clamped unit totals are the
                # exact per-block contribution, hd[U] is not
                total += int(hd[:uhi - ulo].sum())
                all_unit = all_unit and bool(hd[U + 1])
                wrows = units[uhi - 1][1] - units[ulo][0]
                for i in range(ulo, uhi):
                    times[i] = worker_us[w] * (units[i][1] - units[i][0]) \
                        / max(1, wrows)
            self._last_unit_totals = unit_totals
            self.stats.probe_schedule = {
                "policy": policy,
                "route": route,
                "units": [(a, b - a, us)
                          for (a, b), us in zip(units, times)],
                "worker_micros": worker_us,
                "imbalance": sync_stats(worker_us)["imbalance"],
            }
        return total, all_unit

    def _scheduled_probe(self, parts: PartitionedTable, probe_keys,
                         plan):
        """Scheduled probe execution: each worker's block of units is
        enqueued as one chain of device work (per-unit totals fall out of
        a boundary cumsum inside it) and followed by a mark of its
        completion (a CUDA event on the card), and the blocks' small heads
        are read back together, one wait (``_record_schedule``).
        ProbeIsPart and ProbeSteal produce different decompositions
        (different measured schedules), identical results.  The host
        planning of the pad is an ``hj.schedule`` span."""
        policy, units, blocks, route, U = plan
        dev = probe_keys.device
        with span("hj.schedule"):
            W = max(8, next_pow2(max(units[b - 1][1] - units[a][0]
                                     for a, b in blocks)))
            # one shape serves every block: pad unit counts to U, rows to
            # W; pad probe keys once so every slice is in-bounds.  Pad keys
            # are NEGATIVE sentinels below every real key (dense/perm
            # routes exclude key < 0; searched routes sort them below all
            # certified keys) — they match nothing and do not void the
            # per-unit identity certificate.
            if route in ("perm", "dense"):
                pad_val, use_i32 = -1, True
            else:
                kb = (_keys_absmax(self._build_keys_sorted, probe_keys)
                      if probe_keys.element_size() <= 4
                      and self._build_keys_sorted.element_size() <= 4
                      else _I32_COMP_LIMIT)
                use_i32 = kb < _I32_COMP_LIMIT
                pad_val = _PAD_PROBE_I32 if use_i32 else _PAD_PROBE_I64
                if not use_i32 and probe_keys.element_size() <= 4:
                    # int64 route with narrow probe keys: widen once so
                    # the pad sentinel sits strictly outside the key domain
                    probe_keys = probe_keys.long()
        pk_pad = torch.cat([probe_keys, probe_keys.new_full((W,), pad_val)])

        def block_args(ulo, uhi):
            a0, ub = _block_ubounds(units, ulo, uhi, U)
            return a0, _upload(ub, dev)

        if route == "perm":
            def run(start, ub, ulo, uhi):
                return _block_bounds_perm(W, pk_pad, start, ub, self._kmin,
                                          self._kmax)
        elif route == "dense":
            def run(start, ub, ulo, uhi):
                return _block_bounds_dense(W, pk_pad, start, ub,
                                           *self._dense_tbl)
        elif route == "local":
            bkeys_ps, g_of_l = self._plocal_arrays()
            _, _, offs, szs = self._build_parts_meta
            # units <-> nonempty probe partitions, in order (the schedule
            # bounds collapse empty partitions); build slice of unit u =
            # the SAME partition id's run in the part-sorted build
            pids = np.where(np.asarray(parts.sizes) > 0)[0]
            BP = max(8, next_pow2(int(szs.max()) if len(szs) else 1))
            PP = max(8, next_pow2(max(b - a for a, b in units)))

            def run(start, ub, ulo, uhi):
                b0 = np.zeros((U,), np.int64)
                bl = np.zeros((U,), np.int64)
                b0[:uhi - ulo] = offs[pids[ulo:uhi]]
                bl[:uhi - ulo] = szs[pids[ulo:uhi]]
                return _block_bounds_local(
                    W, U, BP, PP, use_i32, pk_pad, start, ub, bkeys_ps,
                    _upload(b0, dev), _upload(bl, dev), g_of_l)
        else:
            def run(start, ub, ulo, uhi):
                return _block_bounds_sorted(W, use_i32, pk_pad, start, ub,
                                            self._build_keys_sorted)

        # enqueue every worker's block, each followed by a mark of its
        # completion; then every block's small head in one readback
        origin = _Mark(dev)
        outs, marks = [], []
        for (ulo, uhi) in blocks:
            start, ub = block_args(ulo, uhi)
            outs.append(run(start, ub, ulo, uhi))
            marks.append(_Mark(dev))
        heads = readback_array(torch.stack([o[2] for o in outs]))
        total, all_unit = self._record_schedule(plan, heads, origin, marks)
        los = [o[0][:units[uhi - 1][1] - units[ulo][0]]
               for (ulo, uhi), o in zip(blocks, outs)]
        his = [o[1][:units[uhi - 1][1] - units[ulo][0]]
               for (ulo, uhi), o in zip(blocks, outs)]
        lo = torch.cat(los) if len(los) > 1 else los[0]
        hi = torch.cat(his) if len(his) > 1 else his[0]
        return lo, hi, total, all_unit

    def _kernel_probe(self, table: Table, probe_keys, n: int, plan):
        """The "perm" route's probe and emit as one launch of
        ``multijoin_probe`` a worker block: each probe row's output at its
        own index (R's payload of rank key - kmin, the row's selected
        value), each unit's matches and the block's head counted on the
        device, the heads read back together, one wait.  Taken where the
        code can see that the emit is the identity's: the permutation
        route under ProbeIsPart, StoreCopy's key-ordered payload, int32
        key, payload and selected columns, one of each, on the card.
        Returns the output, or None where the route is not taken or the
        heads void the certificate (a probe key with no match): the
        speculative output is then dropped, and the caller runs the torch
        route from the start.  Everything before the first launch is an
        ``hj.schedule`` span; the launches and the heads' readback are
        not."""
        global PROBE_KERNEL_BLOCKS
        policy, units, blocks, route, U = plan
        with span("hj.schedule"):
            if (route != "perm" or policy != "probe_is_part"
                    or self.storage != "copy"
                    or len(self._build_payload) != 1
                    or len(self.sel2) != 1 or not _on_card(probe_keys)):
                return None
            payload, col = self._build_payload[0], table.column(self.sel2[0])
            if not all(isinstance(c, torch.Tensor) and c.dtype == torch.int32
                       and c.dim() == 1 for c in (probe_keys, payload, col)):
                return None
            keys, col = probe_keys.contiguous(), col.contiguous()
            dev = keys.device
            cap = max(8, next_pow2(n))
            out_build = torch.empty((cap,), dtype=torch.int32, device=dev)
            out_probe = torch.empty_like(out_build)
            ubs = np.stack([_block_ubounds(units, ulo, uhi, U)[1]
                            for ulo, uhi in blocks])
            ubs = _upload(ubs, dev)
            heads = new_heads(len(blocks), U, dev)
        origin = _Mark(dev)
        marks = []
        for b, (ulo, uhi) in enumerate(blocks):
            a0 = units[ulo][0]
            multijoin_probe(keys, col, payload, self._kmin, self._kmax, a0,
                            units[uhi - 1][1] - a0, ubs[b], out_build,
                            out_probe, heads[b])
            marks.append(_Mark(dev))
        total, all_unit = self._record_schedule(
            plan, readback_array(heads), origin, marks)
        if not all_unit or total != n:
            return None
        if cap > n:   # the torch emit's tail: rank 0 and a zero
            out_build[n:].copy_(payload[:1].expand(cap - n))
            out_probe[n:].zero_()
        PROBE_KERNEL_BLOCKS += len(blocks)
        self.stats.output_rows = n
        return Table(self.sout, [out_build, out_probe],
                     self.output_page_size, rows=n)

    def probe(self, parts: PartitionedTable) -> Table:
        """ProbeIsPart walks this worker's partitions; ProbeSteal
        cost-balances chunks across workers (probe.inl:18-52).  Both
        policies EXECUTE per schedule unit with measured per-unit timings
        (_scheduled_probe, or _kernel_probe on its route); ProbeIsNotPart
        runs the whole probe at once."""
        table = parts.table
        probe_keys = table.key_column(self.ja2)
        n = int(probe_keys.shape[0])
        self.stats.probe_rows = table.num_rows

        output = None
        if (self.partition_probe or self.steal) and n:
            with span("hj.schedule"):
                plan = self._schedule(parts, probe_keys, n)
            output = self._kernel_probe(table, probe_keys, n, plan)
            if output is None:
                lo, hi, total, all_unit = self._scheduled_probe(
                    parts, probe_keys, plan)
            with span("hj.schedule"):
                if self.stats.probe_schedule["policy"] == "probe_is_part":
                    # units ARE the nonempty partitions: per-partition
                    # cost = in-block unit totals + rows, no extra device
                    # pass
                    sizes_np = np.asarray(parts.sizes, np.int64)
                    costs = np.zeros((parts.nparts,), np.int64)
                    nz = np.where(sizes_np > 0)[0]
                    costs[nz] = self._last_unit_totals + sizes_np[nz]
                    self.stats.partition_probe_costs = costs
                else:
                    # steal chunks cross partition bounds
                    starts = _upload(np.asarray(parts.offsets, np.int64),
                                     lo.device)
                    ends = starts + _upload(
                        np.asarray(parts.sizes, np.int64), lo.device)
                    self.stats.partition_probe_costs = host(
                        _partition_costs(lo, hi, starts, ends))
        else:
            lo, hi, total, all_unit = self._bounds(probe_keys)
        if output is not None:
            return output

        if self.storage == "copy":
            payload_cols = self._build_payload
        else:
            # late materialization: emit gathers through the row pointers
            payload_cols = [_gather(self._build_table.column(c),
                                    self._build_perm) for c in self.sel1]
        return self._emit(table, lo, hi, total, payload_cols,
                          unit_counts=all_unit)


# ---------------------------------------------------------------------------
# NestedLoops (algo/nl.cpp)
# ---------------------------------------------------------------------------

class NestedLoops(BaseJoiner):
    """Blocked all-pairs equi-join (algo/nl.cpp joinPagePage1).  Kept for the
    small/unhashable case and as the brute-force oracle: ``probe`` answers
    through the sorted formulation, ``brute_count`` runs the literal tiled
    compare loop.  O(|R|·|S|) — use only for small inputs."""

    def __init__(self, output_page_size: int = 1 << 20, tile: int = 4096):
        super().__init__(None, output_page_size)
        self.tile = tile

    def build(self, parts: PartitionedTable) -> None:
        self._build_table = parts.table
        self.stats.build_rows = parts.table.num_rows

    def probe(self, parts: PartitionedTable) -> Table:
        table = parts.table
        bkeys = self._build_table.key_column(self.ja1).long()
        pkeys = table.key_column(self.ja2).long()
        self.stats.probe_rows = table.num_rows
        order = torch.argsort(bkeys, stable=True)
        skeys = bkeys[order]
        self._pkeys_cache = pkeys
        lo, hi, total = _match_bounds(skeys, pkeys)
        payload_cols = [_gather(self._build_table.column(c), order)
                        for c in self.sel1]
        return self._emit(table, lo, hi, readback(total), payload_cols)

    def brute_count(self) -> int:
        """Tiled all-pairs count — the literal nl.cpp loop, for validation."""
        pkeys = getattr(self, "_pkeys_cache", None)
        if pkeys is None:
            raise RuntimeError("call probe() first")
        bkeys = self._build_table.key_column(self.ja1).long()
        # pad the build side to a tile multiple with a sentinel no key equals
        pad = (-bkeys.shape[0]) % self.tile
        bp = torch.cat([bkeys, bkeys.new_full((pad,),
                                              torch.iinfo(torch.int64).min)])
        total = 0
        for tile_keys in bp.view(-1, self.tile):
            total += int((tile_keys[None, :] == pkeys[:, None]).sum())
        return total


# ---------------------------------------------------------------------------
# FlatMemoryJoiner (algo/flatmem.cpp)
# ---------------------------------------------------------------------------

class FlatMemoryJoiner(BaseJoiner):
    """Radix flat-array build + histogram-range probe (flatmem.cpp:70-177).

    The build *is* the radix partitioner's output (build() just runs the
    final split, flatmem.cpp:104-109); probe finds each key's bucket range
    from the inclusive histogram and scans it.  Here the radix-partitioned
    flat array is sorted within partitions, so the range scan is a
    bucket-masked binary search: composite (bucket << 32 | key) makes both
    steps one search.
    """

    def __init__(self, hashfn: HashFunction,
                 partitioner: RadixPartitioner,
                 output_page_size: int = 1 << 20):
        super().__init__(hashfn, output_page_size)
        self.partitioner = partitioner

    def build(self, parts: PartitionedTable) -> None:
        """parts must come from the RadixPartitioner (driver wires this);
        the flat array is its reordered table.

        Because bucket = hash(key) is a FUNCTION of the key, equal keys
        are contiguous in the (bucket, key)-sorted flat array — so for a
        dense bounded key range a start/count DIRECTORY over the keyspace
        answers every probe with gathers.  Sparse/wide keys keep the
        composite path."""
        table = parts.table
        keys32 = table.key_column(self.ja1)
        keys = keys32.long()
        buckets = self.partitioner.hashfn.hash(keys32).long()
        comp = (buckets << 32) | (keys & 0xFFFFFFFF)
        order = torch.argsort(comp, stable=True)
        self._flat_comp = comp[order]
        self._order = order
        self._build_table = table
        self.stats.build_rows = table.num_rows
        self.stats.bucket_count = self.partitioner.hashfn.buckets
        self._flat_dir = None
        self._flat_perm = None
        if table.num_rows:
            kmin, kmax = readback(torch.stack([keys.min(), keys.max()]))
            if 0 <= kmin and kmax < _DENSE_LIMIT \
                    and kmax < max(16 * table.num_rows, 1 << 20):
                kf = keys32.to(torch.int32)[order]
                start_tbl, cnt_tbl = _flat_directory(kf, next_pow2(kmax + 2))
                self._flat_dir = (start_tbl, cnt_tbl)
                if (kmax - kmin + 1 == table.num_rows
                        and readback(cnt_tbl.max()) == 1):
                    # permutation certificate (the canonical 16M PK build,
                    # wisconsin-src/datagen/genbuild.py): probe ranks are
                    # ARITHMETIC in key order, so the per-probe directory
                    # gathers (the reference's histogram-range walk,
                    # flatmem.cpp:147-160) vanish — the emit gathers build
                    # payload through a key-ordered copy instead.  The
                    # flat radix artifact and its inclusive histogram stay
                    # the observable build product.
                    self._flat_perm = (kmin, kmax, torch.argsort(
                        keys32.to(torch.int32), stable=True))

    def probe(self, parts: PartitionedTable) -> Table:
        table = parts.table
        self.stats.probe_rows = table.num_rows
        if self._flat_perm is not None:
            kmin, kmax, order_key = self._flat_perm
            lo, hi, head = _dense_bounds_perm(table.key_column(self.ja2),
                                              kmin, kmax)
            tot, unit = readback(head)
            payload_cols = [_gather(self._build_table.column(c), order_key)
                            for c in self.sel1]
            return self._emit(table, lo, hi, tot, payload_cols,
                              unit_counts=bool(unit))
        payload_cols = [_gather(self._build_table.column(c), self._order)
                        for c in self.sel1]
        if self._flat_dir is not None:
            lo, hi, head = _flat_dense_bounds(*self._flat_dir,
                                              table.key_column(self.ja2))
            tot, unit = readback(head)
            return self._emit(table, lo, hi, tot, payload_cols,
                              unit_counts=bool(unit))
        pkeys = table.key_column(self.ja2).long()
        pbuckets = self.partitioner.hashfn.hash(
            table.key_column(self.ja2)).long()
        pcomp = (pbuckets << 32) | (pkeys & 0xFFFFFFFF)
        lo, hi, total = _match_bounds(self._flat_comp, pcomp)
        return self._emit(table, lo, hi, readback(total), payload_cols)


# ---------------------------------------------------------------------------
# Factory (joinerfactory.cpp:23-75)
# ---------------------------------------------------------------------------

def joiner_factory(conf: dict, hashfn: HashFunction,
                   build_partitioner=None) -> BaseJoiner:
    """Instantiate the lattice from the conf's algorithm group:
    flatmem/copydata/partitionbuild/partitionprobe/steal strings, exactly the
    reference's dispatch (joinerfactory.cpp:28-70)."""
    algo = conf.get("algorithm", {})

    def yes(k, d="no"):
        return str(algo.get(k, d)).lower() == "yes"

    if yes("flatmem"):
        if not isinstance(build_partitioner, RadixPartitioner):
            raise ValueError("flatmem requires a radix build partitioner "
                             "(flatmem.cpp custominit)")
        return FlatMemoryJoiner(hashfn, build_partitioner)
    if yes("nestedloops"):
        return NestedLoops()
    return HashJoiner(
        hashfn,
        storage="copy" if yes("copydata", "yes") else "pointer",
        partition_build=yes("partitionbuild"),
        partition_probe=yes("partitionprobe"),
        steal=yes("steal"),
        build_page_size=algo.get("buildpagesize", 32),
        nthreads=int(conf.get("threads", 1)),
    )
