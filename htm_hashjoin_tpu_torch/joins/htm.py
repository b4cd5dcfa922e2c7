"""HTM join: the headline locality-exploiting build.

Counterpart of ``htm_hashjoin_tpu/joins/htm.py`` (reference
HTMHashBuild.hpp:54-464).  Two formulations, routed as in
``joins/common.py``:

  * the banded engine: the optimistic tile sort is the transaction,
    sortedness violations are the aborts, the exact bitonic re-sort is
    TM_RETRY and band overflow is the conflicts spill; HTM_ADAPT is a real
    dial (the sniffed displacement picks the sorter);
  * the scatter build (``--backend xla``, duplicate build keys without a
    probe, keys at or above PACK_LIMIT): ``insert.htm_optimistic_build``,
    one optimistic scatter at bucket*3 + key%3 (the transaction),
    gather-back failure detection (the aborts), claim rounds into the
    bucket's free slots (TM_RETRY) and the spill of the rest; the
    per-16384-tuple failure fractions that drove HTM_ADAPT are computed
    and replayed through its controller.

HTM_SWITCH sends data without locality to the radix join.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Optional

import torch

from ..config import JoinConfig
from ..ops import insert, probe
from ..ops.hashing import locality_hash
from ..relation import Relation
from ..utils.metrics import JoinMetrics
from ..utils.profiler import span
from ..utils.timing import readback
from .banded_backend import (DEFAULT_TILE, BandedJoinOutcome,
                             banded_build_pipelined, enqueue_banded_build,
                             enqueue_full_join)
from .common import (BandedPlan, _engine, adaptive_guess_plan,
                     adaptive_window_estimate, dial_window, engine_join,
                     engine_line, htm_num_buckets, join_scope,
                     maybe_pipeline_timing, pallas_metrics, pallas_plan,
                     plan_args, probes, scatter_join, sniff_enqueue,
                     sniff_stats_dict, use_pallas_engine,
                     use_pallas_engine_build)


def _adaptive_pallas_plan(r: Relation, cfg: JoinConfig, probing: bool):
    """HTM_ADAPT, sniff first: the measured sample displacement replaces
    the declared window in the sorter choice (HTMHashBuild.hpp:204-211).
    Returns (plan, sniff_stats).  It pays one readback before the engine
    runs; the fused dial (``_htm_dial``) folds the sniff into the engine's
    readback instead.  Kept for the TM_TRACK build, whose per-tile cause
    vectors need the plan up front."""
    est = adaptive_window_estimate(r.keys, cfg)
    window = dial_window(est["maxDisplacement"], est["sampleChunkSize"])
    est["windowEstimate"] = None if window >= (1 << 30) else window
    return pallas_plan(cfg, probing=probing, window_override=window), est


def _adaptive_metrics(m: JoinMetrics, plan: BandedPlan, est: dict,
                      cached: bool = False) -> None:
    """The dial's line fields: the plan it ran and the sniff's statistics
    (``adaptivePlan``), and the transaction size they amount to."""
    m.extra["adaptivePlan"] = {"window": plan.window, "presort": plan.presort,
                               **est}
    if cached:
        m.extra["adaptivePlan"]["dialCached"] = True
    m.extra["adaptiveTransactionSizeFinal"] = max(1, plan.window or 4096)


# Profile-guided dial memory: repeated joins over one relation reuse the
# plan the dial measured.  Keyed by the key tensor's identity and the config
# fields that shape the plan; bounded (drop-oldest).  A stale entry heals
# itself: the cached plan runs under the same violation/overflow guards.
_DIAL_CACHE: dict = {}
_DIAL_CACHE_CAP = 64


def _dial_key(r: Relation, cfg: JoinConfig, probing: bool):
    return (id(r.keys), r.keys.numel(), cfg.data_distr, cfg.shuffle_range,
            probing)


def _dial_lookup(key, keys):
    """A hit only while the stored weakref still points at the same live
    tensor: CPython reuses an id() after garbage collection."""
    ent = _DIAL_CACHE.get(key)
    if ent is None:
        return None
    ref, plan, est = ent
    if ref() is not keys:
        del _DIAL_CACHE[key]
        return None
    return plan, est


def _dial_remember(key, keys, plan, est):
    if len(_DIAL_CACHE) >= _DIAL_CACHE_CAP:
        _DIAL_CACHE.pop(next(iter(_DIAL_CACHE)))
    _DIAL_CACHE[key] = (weakref.ref(keys), plan, est)


def _htm_dial(r: Relation, s: Optional[Relation],
              cfg: JoinConfig) -> JoinMetrics:
    """HTM_ADAPT with the sniff folded into the engine chain, over the join
    or (``s`` None) the build alone: the displacement sniff and the engine
    under an optimistic guess plan are enqueued back to back; one readback
    returns the engine's scalars and the sniff statistics.  A clean guess
    (no violations, no flagged tiles) costs the engine run and nothing
    more; a dirty one replans from the sniffed displacement and reruns
    through the self-repairing pipeline (the abort -> retry protocol, with
    the dial riding the abort)."""
    probing = s is not None
    with span("hj.plan"):
        ck = _dial_key(r, cfg, probing)
        cached = _dial_lookup(ck, r.keys)
    if cached is not None:
        plan, est = cached
        return engine_join(
            "htm", r, s, cfg, plan,
            lambda m: _adaptive_metrics(m, plan, est, cached=True))
    t0 = time.perf_counter()
    sniff_dev, chunk, k = sniff_enqueue(r.keys, cfg)        # no fence
    with span("hj.plan"):
        guess = adaptive_guess_plan(cfg, probing=probing)
    if probing:
        # five scalars: matches, violations, flagged tiles, out_sum, in_sum
        head = torch.stack(enqueue_full_join(
            r.keys, s.keys, **plan_args(guess, cfg, s))[:5])
    else:
        # three scalars: violations, out_sum, in_sum
        head = enqueue_banded_build(r.keys, **plan_args(guess))
    # the one readback: the engine's scalars and the sniff's statistics
    *scalars, mx, dups = readback(torch.cat([head, sniff_dev]))
    matches, viols, flagged, out_sum, in_sum = (
        scalars if probing else (0, scalars[0], 0, *scalars[1:]))
    with span("hj.plan"):
        est = sniff_stats_dict(mx, dups, chunk, k)
        window = dial_window(mx, chunk)
        est["windowEstimate"] = None if window >= (1 << 30) else window
        aborted = bool(viols or flagged)
        if aborted:
            plan = pallas_plan(cfg, probing=probing, window_override=window)
    if aborted:
        # abort -> the dialed repair run (the self-repairing pipeline
        # handles its own overflow and mass replan)
        with span("hj.plan"):
            fresh, _ = _engine(r, s, cfg, plan)
        out = fresh._replace(violations=max(fresh.violations, viols),
                             resorted=True)
        # sustained timing measures the dialed plan: the guess miss stays
        # in the single-run number only
        pipe_ref = fresh
    else:
        plan = guess
        out = BandedJoinOutcome(matches, 0, 0, out_sum, False, in_sum)
        pipe_ref = out
    elapsed_us = (time.perf_counter() - t0) * 1e6

    def fields(m: JoinMetrics) -> None:
        _dial_remember(ck, r.keys, plan, est)
        _adaptive_metrics(m, plan, est)

    return engine_line("htm", r, s, cfg, plan, out, elapsed_us, fields,
                       pipe_ref)


def _probe(table: torch.Tensor, skeys: torch.Tensor) -> torch.Tensor:
    return probe.probe_buckets(table, skeys, 3, locality_hash)


def simulate_adaptive_tsize(chunk_fail, t0: int) -> list[int]:
    """Replay of the HTM_ADAPT controller (HTMHashBuild.hpp:204-211):
    failure fraction < 0.004 => tSize *= 2 (cap 4096); > 0.02 => tSize /= 2
    (floor 1)."""
    t, out = t0, []
    for f in chunk_fail:
        if f < 0.004:
            t = min(t * 2, 4096)
        elif f > 0.020:
            t = max(t // 2, 1)
        out.append(t)
    return out


@join_scope
def htm_join(r: Relation, s: Optional[Relation] = None,
             cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    if cfg.switch_sniff:
        return _htm_switch_join(r, s, cfg)
    probing = use_pallas_engine(cfg, s)
    building = not probes(s, cfg) and use_pallas_engine_build(cfg)
    if not (probing or building):
        return _htm_scatter_join(r, s, cfg)
    # the banded engine: the join (one host readback on the fast path), or
    # the build alone (ENABLE_PROBE off, the reference's default binary),
    # the optimistic tile sort being the build there; violations map to
    # failedTransactions, the bitonic retry to TM_RETRY
    s = s if probing else None
    if cfg.track and building:
        return _htm_track_build(r, cfg)
    if cfg.adaptive:
        return _htm_dial(r, s, cfg)
    return engine_join("htm", r, s, cfg,
                       fields=_failure_causes if cfg.track else None)


def _failure_causes(m: JoinMetrics) -> None:
    """TM_TRACK on the engine's join: its two failure modes, displacement
    violations of the optimistic sorter and band overflow of the count."""
    m.extra["failureCauseDisplacement"] = m.failedTransactions
    m.extra["failureCauseBandOverflow"] = m.conflictCount


def _htm_scatter_join(r: Relation, s: Optional[Relation],
                      cfg: JoinConfig) -> JoinMetrics:
    """The scatter build and its bucket probe, plus the spill's probe.
    TM_TRACK's causes on this path: an optimistic-slot loss is a
    duplicate or bucket alias (_XABORT_CONFLICT), a claim-round residue
    that spilled is capacity (_XABORT_CAPACITY); nothing here assumes a
    bounded displacement, so that cause is 0."""
    chunk_fail = []

    def build(keys: torch.Tensor):
        res = insert.htm_optimistic_build(
            keys, htm_num_buckets(cfg.r_size), retry=cfg.retry)
        failed = torch.sum(res.failed_optimistic, dtype=torch.int64)
        # the per-chunk failure fractions stay on the device until TM_TRACK
        # or HTM_ADAPT reads them
        chunk_fail.append(insert.chunk_failure_fractions(
            res.failed_optimistic, cfg.chunk_size))
        return res.table, res.pending, failed

    def fields(m: JoinMetrics, failed: int) -> None:
        m.failedTransactions = failed
        cf = readback(chunk_fail[0]) if (cfg.track or cfg.adaptive) else []
        if cfg.track:
            m.extra["chunkFailureFractions"] = cf[:64]
            m.extra["maxChunkFailureFraction"] = max(cf) if cf else 0.0
            m.extra["failureCauseDisplacement"] = 0
            m.extra["failureCauseDuplicateAlias"] = failed
            m.extra["failureCauseBandOverflow"] = m.conflictCount
        if cfg.adaptive:
            trace = simulate_adaptive_tsize(cf, cfg.transaction_size)
            m.extra["adaptiveTransactionSizeFinal"] = (
                trace[-1] if trace else cfg.transaction_size)

    return scatter_join("htm", r, s, cfg, build, _probe, fields=fields)


def _htm_switch_join(r: Relation, s: Optional[Relation],
                     cfg: JoinConfig) -> JoinMetrics:
    """HTM_SWITCH (config.h:16-17): a pre-pass samples the relation and
    measures firstRoundFailureFraction (HTMHashBuild.hpp:100-154); no
    locality switches the build to the radix join, the paper's
    low-overhead switch (README.md:6)."""
    from .adaptive import sniff_statistics
    from .radix import radix_join

    dup_frac, max_key, sniff_us = sniff_statistics(r.keys, cfg)
    with span("hj.plan"):
        use_htm = (dup_frac < 0.004
                   and max_key <= 3 * htm_num_buckets(cfg.r_size))
        inner = dataclasses.replace(cfg, switch_sniff=False)
    if use_htm:
        m = htm_join(r, s, inner)
    else:
        m = radix_join(r, s, inner)
        m.algo = "htm"
        m.extra["switchedToRadix"] = True
    m.firstRoundTime = sniff_us
    m.firstRoundFailureFraction = float(dup_frac)
    return m


def _htm_track_build(r: Relation, cfg: JoinConfig) -> JoinMetrics:
    """TM_TRACK on the engine's build: the per-tile violation and
    duplicate-alias vectors ride the build's readback, so the plan comes
    first (with HTM_ADAPT, the sniff-first dial)."""
    sniff = None
    if cfg.adaptive:
        plan, sniff = _adaptive_pallas_plan(r, cfg, probing=False)
    else:
        plan = pallas_plan(cfg, probing=False)
    t0 = time.perf_counter()
    out, tile_viols, tile_dups = banded_build_pipelined(
        r.keys, **plan_args(plan), return_tile_violations=True)
    elapsed_us = (time.perf_counter() - t0) * 1e6
    m = pallas_metrics(cfg, "htm", out, elapsed_us, None, plan=plan)
    # TM_TRACK abort-histogram analog (HTMHashBuild.hpp:134-142): the
    # per-tile violation fractions of the optimistic sorter, a chunk
    # being one of the port's tiles (the JAX package divides by its
    # own 65536-key tile)
    frac = (tile_viols / DEFAULT_TILE).tolist()
    m.extra["chunkFailureFractions"] = [float(f) for f in frac[:64]]
    m.extra["maxChunkFailureFraction"] = float(max(frac)) if frac else 0.0
    # the reference's "Conflict Reason" split in the engine's failure
    # modes: displacement past the sorter's reach, a duplicate key
    # aliasing a slot, band overflow (none without a probe)
    m.extra["failureCauseDisplacement"] = int(tile_viols.sum())
    m.extra["failureCauseDuplicateAlias"] = int(tile_dups.sum())
    m.extra["failureCauseBandOverflow"] = out.overflow_tiles
    dup_frac = (tile_dups / DEFAULT_TILE).tolist()
    m.extra["duplicateAliasFractions"] = [float(f) for f in dup_frac[:64]]
    if sniff is not None:
        _adaptive_metrics(m, plan, sniff)
    maybe_pipeline_timing(m, cfg, plan, r, None, out)
    return m
