"""Distributed hash join over a mesh of shards (counterpart of
``htm_hashjoin_tpu/parallel/dist_join.py``).

The reference is single-process shared-memory; its "communication" is
pthread barriers and cache-coherent shared tables.  The JAX package adds a
distributed layer: relations are row-sharded over a mesh,
hash-repartitioned with ``lax.all_to_all`` (the distributed analog of
parallel_radix_partition's barrier + prefix-sum + scatter,
mc/src/parallel_radix_join.c:559-627), joined locally per shard, and
match counts reduced with ``psum`` (the analog of the pthread_join result
summation, mc/src/no_partitioning_join.c:595-599).  Here the body that JAX
runs under ``shard_map`` is a sequence of steps over the shard list, with
the single-controller collectives of ``collectives.py`` between them.

Skew handling (SKEW_HANDLING, mc/src/parallel_radix_join.c:958-1055): a
sampled global histogram (all_gather of per-shard samples) finds heavy
hitters; hot tuples never move, and their matches are the product of two
psum'd per-key counts.  Non-hot tuples take the all_to_all path.  With
``residual_repair`` (the default), tuples that miss their destination
bucket are compacted into a residual buffer and joined exactly by a
cooperative repair round (``_residual_matches``); ``residual_repair=False``
reports them as dropped.

Padding is known by position and count, never by value.  The JAX package
marks padding with sentinels (R: INT32_MAX, S: 0) and compares against
them, so a real R key 0 matches every S padding slot and a real S key
INT32_MAX every R padding slot (its generators never draw either key).
Here input padding is known by index (``index < n``), each send bucket's
fill travels with it through the same all_to_all, residual buffers carry
their counts, and the count's composite gives padding values that no
``key*2+tag`` of an int32 key takes.  On generator keys every field
equals the JAX package's.

One readback happens before the repair round: the per-shard residual
counts, which decide whether it runs (JAX's ``lax.cond``) and trim each
shard's residual buffer to its tuples.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from ..config import JoinConfig
from ..ops.hashing import murmur32
from ..ops.probe import segmented_count_tagged
from ..relation import Relation
from ..utils.metrics import JoinMetrics
from ..utils.timing import PhaseTimer
from . import collectives as cc
from .mesh import Mesh, make_mesh, shard_relation

# Fill of unused bucket and residual slots, the JAX package's sentinels;
# here a fill value only: no step reads a slot past its count.
R_PAD = (1 << 31) - 1
S_PAD = 0

HOT_CAP = 128          # max distinct heavy-hitter keys tracked
SAMPLE_PER_DEV = 2048  # per-shard sample for the skew sniff
HOT_PAD = 1 << 32      # padding of the (int64) hot set: no int32 key

# Padding composites of _count_sorted: every key*2+tag of an int32 key lies
# in [-2^32, 2^32 - 1].  An R pad is a build element of key 2^32, an S pad
# probes key 2^34; neither meets the other or a real key.
_R_COMP_PAD = 1 << 33
_S_COMP_PAD = (1 << 34) + 1


def _bucketize_by(keys, dest, active, nbuckets, cap, pad_value, res_cap=0):
    """Sort local keys by a precomputed bucket index (stably) and pack them
    into (nbuckets, cap) send buckets.  Returns (buckets, fill, residual,
    n_residual, overflow, active_sum): ``fill[b]`` = min(count, cap) keys
    at the front of bucket b (the rest of it holds ``pad_value``), and
    ``residual`` a (res_cap,) buffer whose first ``n_residual`` slots hold
    the tuples that did NOT fit their destination bucket, in bucket order
    (the raw material of the repair round — the analog of the reference's
    oversized-partition list, mc/src/parallel_radix_join.c:958-1055).
    res_cap=0 skips the residual (zero length, count 0)."""
    n = keys.numel()
    dev = keys.device
    dest = torch.where(active, dest.to(torch.int32), nbuckets)
    dest_s, order = torch.sort(dest, stable=True)
    keys_s = keys[order]
    bounds = torch.searchsorted(
        dest_s, torch.arange(nbuckets + 2, dtype=torch.int32, device=dev))
    offsets = bounds[:-1]
    pos = torch.arange(n, device=dev) - offsets[dest_s.long()]
    real = dest_s < nbuckets
    ok = (pos < cap) & real
    slot = torch.where(ok, dest_s.long() * cap + pos, nbuckets * cap)
    buf = torch.full((nbuckets * cap + 1,), pad_value, dtype=keys.dtype,
                     device=dev)
    buf[slot] = keys_s               # the last slot takes every misfit
    fill = (bounds[1:-1] - offsets[:-1]).clamp(max=cap)
    overflow = active.sum(dtype=torch.int64) - ok.sum(dtype=torch.int64)
    act_sum = torch.where(active, keys, 0).sum(dtype=torch.int64)
    if res_cap > 0:
        failed = real & ~ok
        rank = torch.cumsum(failed, 0) - 1
        keep = failed & (rank < res_cap)
        res = torch.full((res_cap + 1,), pad_value, dtype=keys.dtype,
                         device=dev)
        res[torch.where(keep, rank, res_cap)] = keys_s
        residual, n_res = res[:res_cap], keep.sum(dtype=torch.int64)
    else:
        residual = keys.new_zeros(0)
        n_res = torch.zeros((), dtype=torch.int64, device=dev)
    return buf[:-1].view(nbuckets, cap), fill, residual, n_res, overflow, \
        act_sum


def _bucketize(keys, active, ndev, cap, pad_value, res_cap=0):
    """Pack local keys into per-destination-shard send buckets (flat 1-D
    mesh: destination = hash & (ndev-1))."""
    return _bucketize_by(keys, murmur32(keys) & (ndev - 1), active,
                         ndev, cap, pad_value, res_cap=res_cap)


def _received_ok(fills: torch.Tensor, cap: int) -> torch.Tensor:
    """Which slots of a receive buffer of len(fills) blocks of ``cap`` hold
    tuples: block i's first fills[i]."""
    slots = torch.arange(cap, device=fills.device)
    return (slots < fills[:, None]).reshape(-1)


class Exchanged(NamedTuple):
    """One relation side after the exchange, a list entry a shard: the
    receive buffer and which of its slots hold tuples, the residual buffer
    and its count, and the send-bucket overflow."""
    recv: List[torch.Tensor]
    ok: List[torch.Tensor]
    residual: List[torch.Tensor]
    n_residual: List[torch.Tensor]
    overflow: List[torch.Tensor]


def _exchanged(sent, move, cap) -> Exchanged:
    """Each shard's ``_bucketize`` output after ``move`` (the exchange of
    per-shard (ndev, w) tensors) has taken its buckets, and its fills the
    same way, to their destinations."""
    fills = move([x[1].view(-1, 1) for x in sent])
    return Exchanged(move([x[0] for x in sent]),
                     [_received_ok(f, cap) for f in fills],
                     [x[2] for x in sent], [x[3] for x in sent],
                     [x[4] for x in sent])


def _exchange_flat(keys, active, mesh: Mesh, axis, ndev, cap, pad_value,
                   res_cap=0) -> Exchanged:
    """Bucketize by destination shard, then one all_to_all of the buckets
    and one of their fills."""
    sent = [_bucketize(k, a, ndev, cap, pad_value, res_cap=res_cap)
            for k, a in zip(keys, active)]
    return _exchanged(sent, lambda xs: [
        x.reshape(-1) for x in cc.all_to_all(xs, mesh, axis)], cap)


def _exchange_hier(keys, active, mesh: Mesh, ndev, hosts, chips, cap,
                   pad_value, host_axis="host", chip_axis="chip",
                   res_cap=0) -> Exchanged:
    """FUSED two-stage hierarchical repartition over a (host, chip) mesh:
    the chip-level pass before the host-level pass.  Destination shard for
    key k is d = murmur(k) & (ndev-1), laid out d = h·chips + c.

    ONE bucketize by the FULL destination (exactly the flat exchange's
    sort) packs (ndev, cap) send buckets; the chip-level all_to_all moves
    chip-major blocks, a transpose regroups the received blocks by
    destination host, and the host-level all_to_all finishes.  The fills
    take the same two steps, so each shard receives the flat exchange's
    buffer bit for bit, blocks in source order h·chips + c."""
    sent = [_bucketize(k, a, ndev, cap, pad_value, res_cap=res_cap)
            for k, a in zip(keys, active)]

    def two_stage(xs):
        # (ndev, w) rows keyed d = h·chips + c → (h, c, w) → chip-major
        b = [x.reshape(hosts, chips, -1).transpose(0, 1) for x in xs]
        r1 = cc.all_to_all(b, mesh, chip_axis)
        # r1[src_chip][dest_host] = this host's src_chip tuples for
        # (dest_host, my_chip) — regroup by destination host, no re-sort
        r2 = cc.all_to_all([x.transpose(0, 1) for x in r1], mesh, host_axis)
        return [x.reshape(-1) for x in r2]

    return _exchanged(sent, two_stage, cap)


def _exchange(keys, active, mesh: Mesh, axis, hier, ndev, cap, pad_value,
              res_cap) -> Exchanged:
    """The flat exchange (``hier`` None), or the hierarchical one over a
    (hosts, chips) mesh whose ``axis`` is its pair of axis names."""
    if hier is None:
        return _exchange_flat(keys, active, mesh, axis, ndev, cap, pad_value,
                              res_cap=res_cap)
    (hosts, chips), (h_ax, c_ax) = hier, axis
    return _exchange_hier(keys, active, mesh, ndev, hosts, chips, cap,
                          pad_value, host_axis=h_ax, chip_axis=c_ax,
                          res_cap=res_cap)


def _residual_counts(r: Exchanged, s: Exchanged) -> torch.Tensor:
    """Every shard's residual count, R's then S's, in one tensor (one
    readback)."""
    dev = r.n_residual[0].device
    return torch.stack([c.to(dev) for c in r.n_residual + s.n_residual])


def _trimmed(side: Exchanged, counts) -> List[torch.Tensor]:
    """Each shard's residual buffer cut to its ``counts`` tuples."""
    return [b[:c] for b, c in zip(side.residual, counts)]


def _hot_set(allsamp: torch.Tensor, ndev: int) -> torch.Tensor:
    """The heavy hitters of one gathered sample: ascending (HOT_CAP,) int64,
    padded with HOT_PAD."""
    total = allsamp.numel()
    dev = allsamp.device
    s = torch.sort(allsamp).values
    is_start = torch.ones_like(s, dtype=torch.bool)
    is_start[1:] = s[1:] != s[:-1]
    run_id = torch.cumsum(is_start, 0) - 1
    counts = torch.zeros(total, dtype=torch.int64, device=dev).scatter_add_(
        0, run_id, torch.ones_like(run_id))
    run_val = torch.full((total,), HOT_PAD, dtype=torch.int64,
                         device=dev).scatter_(0, run_id, s)
    # hot ⇔ sampled frequency implies > half of one device's fair share;
    # at most total / thresh <= 2·ndev keys clear it, so the top HOT_CAP
    # hold them all whatever order topk gives equal counts
    thresh = max(4, total // (2 * ndev))
    top_counts, top_idx = torch.topk(counts, min(HOT_CAP, total))
    vals = run_val[top_idx]
    hot = torch.full((HOT_CAP,), HOT_PAD, dtype=torch.int64, device=dev)
    hot[:vals.numel()] = torch.where(top_counts >= thresh, vals, HOT_PAD)
    return torch.sort(hot).values


def _detect_hot_keys(keys, active, mesh: Mesh, axis, ndev
                     ) -> List[torch.Tensor]:
    """Sampled global heavy-hitter set for one relation side, a list entry a
    shard (one tensor a device): ascending (HOT_CAP,) int64 padded with
    HOT_PAD.  The sampled-histogram analog of the reference's
    oversized-partition threshold test (mc/src/parallel_radix_join.c:
    900-912).  An inactive sample slot takes HOT_PAD, which is never hot."""
    samples = [torch.where(a[:SAMPLE_PER_DEV],
                           k[:SAMPLE_PER_DEV].to(torch.int64), HOT_PAD)
               for k, a in zip(keys, active)]
    gathered = cc.all_gather(samples, mesh, axis, tiled=True)
    made = {}                     # one hot set a gathered (device) tensor
    for g in gathered:
        if id(g) not in made:
            made[id(g)] = _hot_set(g, ndev)
    return [made[id(g)] for g in gathered]


def _union_hot(a, b):
    """Union of two sorted HOT_PAD-padded hot sets, deduplicated, sorted."""
    cat = torch.sort(torch.cat([a, b])).values
    dup = torch.zeros_like(cat, dtype=torch.bool)
    dup[1:] = cat[1:] == cat[:-1]
    return torch.sort(torch.where(dup, HOT_PAD, cat)).values


def _hot_counts(keys, hot_mask, hot_set, size):
    """Per-hot-key local multiplicity (segment count into the hot set)."""
    idx = torch.searchsorted(hot_set, keys.to(torch.int64))
    tgt = torch.where(hot_mask, idx.clamp(0, size - 1), size)
    return torch.bincount(tgt, minlength=size + 1)[:size]


def _is_member(keys, sorted_set):
    k = keys.to(torch.int64)
    idx = torch.searchsorted(sorted_set, k).clamp(0, sorted_set.numel() - 1)
    return sorted_set[idx] == k


def _count_sorted(build, probe, build_ok=None, probe_ok=None):
    """Multiset match count (int64 scalar) of ``build`` against ``probe``:
    the port's ``ops/probe.probe_sorted`` (one sort of the int64
    ``key*2+tag`` composite, then ``segmented_count_tagged``), where the
    slots that ``build_ok`` / ``probe_ok`` leave out take composites that
    match nothing."""
    b = build.to(torch.int64) * 2
    p = probe.to(torch.int64) * 2 + 1
    if build_ok is not None:
        b = torch.where(build_ok, b, _R_COMP_PAD)
    if probe_ok is not None:
        p = torch.where(probe_ok, p, _S_COMP_PAD)
    return segmented_count_tagged(torch.sort(torch.cat([b, p])).values)


class DistResult(NamedTuple):
    """The join's reduced results, int64 scalars on shard 0's device."""
    matches: torch.Tensor
    input_sum_r: torch.Tensor
    output_sum_r: torch.Tensor
    dropped_r: torch.Tensor
    dropped_s: torch.Tensor
    repaired_r: torch.Tensor
    repaired_s: torch.Tensor
    num_hot: torch.Tensor


def _is_dev0(mesh: Mesh, axis) -> List[bool]:
    """Whether each shard has index 0 along every axis of ``axis``."""
    names = axis if isinstance(axis, tuple) else (axis,)
    idx = [cc.axis_index(mesh, a) for a in names]
    return [all(i[d] == 0 for i in idx) for d in range(mesh.size)]


def _residual_matches(r_res, s_res, r_recv, s_recv, r_ok, s_ok,
                      mesh: Mesh, axis) -> List[torch.Tensor]:
    """Cooperative repair round: every shard helps join the tuples that
    overflowed their destination bucket — the analog of the reference's
    cooperative re-partitioning of oversized partitions
    (mc/src/parallel_radix_join.c:958-1055).  ``r_res``/``s_res`` hold each
    shard's residual tuples (exactly those); they are replicated with
    all_gather, and the three disjoint cross terms are
      (residual-R x delivered-S)  counted against the LOCAL delivered S,
      (delivered-R x residual-S)  counted against the LOCAL delivered R,
      (residual-R x residual-S)   counted once, on shard 0;
    each delivered tuple lives on exactly one shard, so the psum over the
    per-shard counts tallies every pair exactly once.  Returns the LOCAL
    contributions (the caller psums)."""
    r_all = cc.all_gather(r_res, mesh, axis, tiled=True)
    s_all = cc.all_gather(s_res, mesh, axis, tiled=True)
    out = []
    for d, dev0 in enumerate(_is_dev0(mesh, axis)):
        m = _count_sorted(r_all[d], s_recv[d], probe_ok=s_ok[d]) + \
            _count_sorted(r_recv[d], s_all[d], build_ok=r_ok[d])
        if dev0:
            m = m + _count_sorted(r_all[d], s_all[d])
        out.append(m)
    return out


def _active(shards: Sequence[torch.Tensor], n: int) -> List[torch.Tensor]:
    """Which rows of each shard are input, not padding: global index < n."""
    out, start = [], 0
    for k in shards:
        out.append(torch.arange(start, start + k.numel(), device=k.device) < n)
        start += k.numel()
    return out


def _masked_sums(keys, masks) -> List[torch.Tensor]:
    return [torch.where(m, k, 0).sum(dtype=torch.int64)
            for k, m in zip(keys, masks)]


def _dist_join_local(rk, sk, r_len, s_len, *, mesh: Mesh, ndev, cap_r, cap_s,
                     skew_handling, axis="x", hier=None, res_cap=0
                     ) -> DistResult:
    """The per-shard body (JAX runs it under shard_map) as steps over the
    shard lists ``rk`` and ``sk``, whose first ``r_len`` / ``s_len`` rows
    (in shard order) are input.  ``hier`` is None for the flat 1-D
    exchange, or (hosts, chips) for the two-stage hierarchical exchange
    over a 2-D mesh (axis is then the axis-name tuple, used for the
    reductions).  ``res_cap`` > 0 enables the repair round."""
    def psum0(xs):
        return cc.psum(xs, mesh, axis)[0]

    r_active = _active(rk, r_len)
    s_active = _active(sk, s_len)
    in_sum_r = psum0(_masked_sums(rk, r_active))
    dev = in_sum_r.device

    if skew_handling:
        # Hot keys never move: matches for a hot key k are
        # psum(count_R(k)) * psum(count_S(k)) — two psums of per-key counts
        # replace the reference's cooperative re-partitioning of oversized
        # partitions (mc/src/parallel_radix_join.c:958-1055).
        hot_set = [_union_hot(a, b) for a, b in zip(
            _detect_hot_keys(rk, r_active, mesh, axis, ndev),
            _detect_hot_keys(sk, s_active, mesh, axis, ndev))]
        size = hot_set[0].numel()
        num_hot = cc.pmax([(h < HOT_PAD).sum() for h in hot_set], mesh,
                          axis)[0]
        r_hot = [a & _is_member(k, h)
                 for k, a, h in zip(rk, r_active, hot_set)]
        s_hot = [a & _is_member(k, h)
                 for k, a, h in zip(sk, s_active, hot_set)]
        cr = psum0([_hot_counts(k, m, h, size)
                    for k, m, h in zip(rk, r_hot, hot_set)])
        cs = psum0([_hot_counts(k, m, h, size)
                    for k, m, h in zip(sk, s_hot, hot_set)])
        hot_matches = (cr * cs.to(dev)).sum()
        hot_sum = psum0(_masked_sums(rk, r_hot))
        r_flow = [a & ~h for a, h in zip(r_active, r_hot)]
        s_flow = [a & ~h for a, h in zip(s_active, s_hot)]
    else:
        num_hot = hot_matches = hot_sum = torch.zeros(
            (), dtype=torch.int64, device=dev)
        r_flow, s_flow = r_active, s_active

    r = _exchange(rk, r_flow, mesh, axis, hier, ndev, cap_r, R_PAD, res_cap)
    s = _exchange(sk, s_flow, mesh, axis, hier, ndev, cap_s, S_PAD, res_cap)
    local = [_count_sorted(a, b, ra, sa)
             for a, b, ra, sa in zip(r.recv, s.recv, r.ok, s.ok)]

    if res_cap > 0:
        # the repair round runs only when some bucket overflowed: one
        # readback of every shard's residual counts decides, and trims each
        # residual buffer to its tuples
        counts = _residual_counts(r, s).tolist()
        r_res = _trimmed(r, counts[:ndev])
        s_res = _trimmed(s, counts[ndev:])
        if sum(counts) > 0:
            local = [a + b for a, b in zip(local, _residual_matches(
                r_res, s_res, r.recv, s.recv, r.ok, s.ok, mesh, axis))]
        res_sum_r = [b.sum(dtype=torch.int64) for b in r_res]
        rep_r, rep_s = r.n_residual, s.n_residual
        drop_r = [o - c for o, c in zip(r.overflow, rep_r)]
        drop_s = [o - c for o, c in zip(s.overflow, rep_s)]
    else:
        zeros = [torch.zeros((), dtype=torch.int64, device=k.device)
                 for k in rk]
        rep_r = rep_s = res_sum_r = zeros
        drop_r, drop_s = r.overflow, s.overflow

    recv_sum = _masked_sums(r.recv, r.ok)
    return DistResult(
        matches=psum0(local) + hot_matches,
        input_sum_r=in_sum_r,
        output_sum_r=psum0([a + b for a, b in zip(recv_sum, res_sum_r)])
        + hot_sum,
        dropped_r=psum0(drop_r),
        dropped_s=psum0(drop_s),
        repaired_r=psum0(rep_r),
        repaired_s=psum0(rep_s),
        num_hot=num_hot,
    )


def _caps(ndev: int, n_r: int, n_s: int, capacity_factor: float):
    return (max(8, int(capacity_factor * n_r / (ndev * ndev)) + 8),
            max(8, int(capacity_factor * n_s / (ndev * ndev)) + 8))


def _mesh_axis(mesh: Mesh):
    """The axis the join reduces over: the 1-D mesh's one name, or every
    name of a 2-D mesh."""
    return tuple(mesh.axis_names) if mesh.ndim == 2 else mesh.axis_names[0]


def build_dist_join_fn(mesh: Mesh, n_r: int, n_s: int, *,
                       capacity_factor: float = 2.0,
                       skew_handling: bool = False,
                       residual_repair: bool = True):
    """The distributed join for relations of ``n_r`` and ``n_s`` rows
    (padded to a multiple of the mesh size): ``fn(rk, sk, r_len=n_r,
    s_len=n_s)`` takes the shard lists (``mesh.shard_relation``) and the
    number of input rows of each side, and returns a DistResult.  A 1-D
    mesh uses the flat all_to_all; a 2-D (host, chip) mesh the two-stage
    hierarchical exchange.  With ``residual_repair`` (the default) bucket
    overflow is joined exactly by the repair round instead of dropped."""
    ndev = mesh.size
    cap_r, cap_s = _caps(ndev, n_r, n_s, capacity_factor)
    # a shard's residual is bounded by its shard (every tuple hashing to
    # one hot destination), on both mesh shapes: the hierarchical exchange
    # bucketizes once, by full destination
    res_cap = max(n_r, n_s) // ndev if residual_repair else 0
    hier = tuple(mesh.shape) if mesh.ndim == 2 else None

    def fn(rk, sk, r_len: Optional[int] = None, s_len: Optional[int] = None):
        return _dist_join_local(
            rk, sk, n_r if r_len is None else r_len,
            n_s if s_len is None else s_len, mesh=mesh, ndev=ndev,
            cap_r=cap_r, cap_s=cap_s, skew_handling=skew_handling,
            axis=_mesh_axis(mesh), hier=hier, res_cap=res_cap)
    return fn


def _pad_to(keys: torch.Tensor, multiple: int, pad_value) -> torch.Tensor:
    n = keys.numel()
    pad = (-n) % multiple
    if pad == 0:
        return keys
    return torch.cat([keys, keys.new_full((pad,), pad_value)])


def distributed_join(r: Relation, s: Optional[Relation],
                     cfg: JoinConfig = JoinConfig(),
                     mesh: Optional[Mesh] = None) -> JoinMetrics:
    """Host entry: shard, repartition, join, reduce, on a mesh of the
    relations' device kind (``cfg.mesh_shape``, placed by the device
    mapping) unless ``mesh`` is given.  Emits reference-schema metrics plus
    distributed extras; the results come back in one readback."""
    if mesh is None:
        shape = cfg.mesh_shape or ()
        names = ("host", "chip") if len(shape) == 2 else ("x",)
        mesh = make_mesh(shape, names, device=r.keys.device)
    ndev = mesh.size
    timer = PhaseTimer()
    s_keys = s.keys if s is not None else r.keys.new_zeros(ndev)
    rk = shard_relation(_pad_to(r.keys, ndev, R_PAD), mesh)
    sk = shard_relation(_pad_to(s_keys, ndev, S_PAD), mesh)
    fn = build_dist_join_fn(mesh, ndev * rk[0].numel(), ndev * sk[0].numel(),
                            capacity_factor=cfg.shuffle_capacity_factor,
                            skew_handling=cfg.skew_handling,
                            residual_repair=cfg.residual_repair)
    res = timer.timed("build", fn, rk, sk, r.num_tuples,
                      s.num_tuples if s is not None else 0)
    vals = dict(zip(DistResult._fields, torch.stack(
        [v.to(res.matches.device) for v in res]).tolist()))
    m = JoinMetrics(algo=f"dist_{cfg.algo.value}", rSize=cfg.r_size,
                    transactionSize=cfg.transaction_size,
                    probeLength=cfg.probe_length,
                    inputSum=vals["input_sum_r"],
                    outputSum=vals["output_sum_r"],
                    totalMatches=vals["matches"])
    m.hashBuildTimeInMicroseconds = timer.total()
    m.extra["nDevices"] = ndev
    m.extra["meshShape"] = list(mesh.shape)
    m.extra["hierarchical"] = mesh.ndim == 2
    m.extra["droppedR"] = vals["dropped_r"]
    m.extra["droppedS"] = vals["dropped_s"]
    m.extra["repairedR"] = vals["repaired_r"]
    m.extra["repairedS"] = vals["repaired_s"]
    m.extra["hotKeys"] = vals["num_hot"]
    m.extra["skewHandling"] = cfg.skew_handling
    m.extra["residualRepair"] = cfg.residual_repair
    return m
