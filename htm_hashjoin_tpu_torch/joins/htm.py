"""HTM join: the headline locality-exploiting build, on the banded engine.

Counterpart of ``htm_hashjoin_tpu/joins/htm.py`` (reference
HTMHashBuild.hpp:54-464).  The engine's optimistic tile sort is the
transaction, sortedness violations are the aborts, the exact bitonic
re-sort is TM_RETRY and band overflow is the conflicts spill; HTM_ADAPT is
a real dial (the sniffed displacement picks the sorter), and HTM_SWITCH
sends data without locality to the radix join.

The JAX package's XLA scatter build (``insert.htm_optimistic_build`` with
its claim rounds and spill) needs ``ops/insert.py``, which is not ported
yet (ROADMAP queue 1 item 7): joins that would take it raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Optional

import torch

from ..config import JoinConfig
from ..relation import Relation
from ..utils.metrics import JoinMetrics
from ..utils.timing import PhaseTimer
from .banded_backend import (DEFAULT_TILE, BandedJoinOutcome,
                             banded_build_pipelined, banded_join_pipelined,
                             enqueue_banded_build, enqueue_full_join)
from .common import (BandedPlan, adaptive_guess_plan,
                     adaptive_window_estimate, dial_window, htm_num_buckets,
                     keys_unique_both, maybe_pipeline_timing, pallas_metrics,
                     pallas_plan, sniff_enqueue, sniff_stats_dict,
                     use_pallas_engine, use_pallas_engine_build)

XLA_BUILD_TODO = ("the XLA scatter build of htm (htm_hashjoin_tpu/joins/"
                  "htm.py:_build) needs ops/insert.py, not ported yet: "
                  "ROADMAP queue 1 item 7")


def _adaptive_pallas_plan(r: Relation, cfg: JoinConfig, probing: bool):
    """HTM_ADAPT, sniff first: the measured sample displacement replaces
    the declared window in the sorter choice (HTMHashBuild.hpp:204-211).
    Returns (plan, sniff_stats).  It pays one readback before the engine
    runs; the production adaptive paths fold the sniff into the engine's
    readback instead.  Kept for the TM_TRACK build, whose per-tile cause
    vectors need the plan up front."""
    est = adaptive_window_estimate(r.keys, cfg)
    window = dial_window(est["maxDisplacement"], est["sampleChunkSize"])
    est["windowEstimate"] = None if window >= (1 << 30) else window
    return pallas_plan(cfg, probing=probing, window_override=window), est


def _dialed_plan_extra(plan: BandedPlan, est: dict) -> dict:
    return {"window": plan.window, "presort": plan.presort, **est}


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


def _adaptive_metrics(m: JoinMetrics, plan: BandedPlan, est: dict,
                      cached: bool) -> None:
    m.extra["adaptivePlan"] = _dialed_plan_extra(plan, est)
    if cached:
        m.extra["adaptivePlan"]["dialCached"] = True
    m.extra["adaptiveTransactionSizeFinal"] = max(1, plan.window or 4096)


def _htm_join_pallas_adaptive(r: Relation, s: Relation,
                              cfg: JoinConfig) -> JoinMetrics:
    """HTM_ADAPT with the sniff folded into the engine chain: the
    displacement sniff and the join under an optimistic guess plan are
    enqueued back to back; one readback returns the join's scalars and the
    sniff statistics.  A clean guess (no violations, no flagged tiles)
    costs the engine run and nothing more; a dirty one replans from the
    sniffed displacement and reruns through the self-repairing pipeline
    (the abort -> retry protocol, with the dial riding the abort)."""
    sort_s = not s.assume_sorted
    unique_both = keys_unique_both(cfg)
    ck = _dial_key(r, cfg, True)
    cached = _dial_lookup(ck, r.keys)
    if cached is not None:
        plan, est = cached
        t0 = time.perf_counter()
        out = banded_join_pipelined(r.keys, s.keys,
                                    locality_window=plan.window,
                                    presort=plan.presort,
                                    presorted=plan.presorted,
                                    narrow=plan.narrow, sort_s=sort_s,
                                    unique_both=unique_both)
        elapsed_us = (time.perf_counter() - t0) * 1e6
        m = pallas_metrics(cfg, "htm", out, elapsed_us, out.matches)
        _adaptive_metrics(m, plan, est, True)
        maybe_pipeline_timing(m, cfg, plan, r, s, out)
        return m
    t0 = time.perf_counter()
    sniff_dev, chunk, k = sniff_enqueue(r.keys, cfg)        # no fence
    guess = adaptive_guess_plan(cfg, probing=True)
    res = enqueue_full_join(r.keys, s.keys, locality_window=guess.window,
                            presort=guess.presort, presorted=guess.presorted,
                            narrow=guess.narrow, sort_s=sort_s,
                            unique_both=unique_both)
    matches_i, viols_i, flagged, out_sum, in_sum, mx, dups = torch.cat(
        [torch.stack(res[:5]), sniff_dev]).tolist()         # the one readback
    est = sniff_stats_dict(mx, dups, chunk, k)
    window = dial_window(mx, chunk)
    est["windowEstimate"] = None if window >= (1 << 30) else window
    if viols_i or flagged:
        # abort -> the dialed repair run (the self-repairing pipeline
        # handles its own overflow and mass replan)
        plan = pallas_plan(cfg, window_override=window)
        fresh = banded_join_pipelined(r.keys, s.keys,
                                      locality_window=plan.window,
                                      presort=plan.presort,
                                      presorted=plan.presorted,
                                      narrow=plan.narrow, sort_s=sort_s,
                                      unique_both=unique_both)
        out = fresh._replace(violations=max(fresh.violations, viols_i),
                             resorted=True)
        # sustained timing measures the dialed plan: the guess miss stays
        # in the single-run number only
        pipe_ref = fresh
    else:
        plan = guess
        out = BandedJoinOutcome(matches_i, 0, 0, out_sum, False, in_sum)
        pipe_ref = out
    elapsed_us = (time.perf_counter() - t0) * 1e6
    m = pallas_metrics(cfg, "htm", out, elapsed_us, out.matches)
    _dial_remember(ck, r.keys, plan, est)
    _adaptive_metrics(m, plan, est, False)
    maybe_pipeline_timing(m, cfg, plan, r, s, pipe_ref)
    return m


def _htm_build_pallas_adaptive(cfg: JoinConfig, r: Relation) -> JoinMetrics:
    """Build-only fused dial: sniff and optimistic build share one readback
    (see _htm_join_pallas_adaptive)."""
    ck = _dial_key(r, cfg, False)
    cached = _dial_lookup(ck, r.keys)
    if cached is not None:
        plan, est = cached
        t0 = time.perf_counter()
        out = banded_build_pipelined(r.keys, locality_window=plan.window,
                                     presort=plan.presort,
                                     presorted=plan.presorted)
        elapsed_us = (time.perf_counter() - t0) * 1e6
        m = pallas_metrics(cfg, "htm", out, elapsed_us, None)
        _adaptive_metrics(m, plan, est, True)
        maybe_pipeline_timing(m, cfg, plan, r, None, out)
        return m
    t0 = time.perf_counter()
    sniff_dev, chunk, k = sniff_enqueue(r.keys, cfg)        # no fence
    guess = adaptive_guess_plan(cfg, probing=False)
    head = enqueue_banded_build(r.keys, locality_window=guess.window,
                                presort=guess.presort,
                                presorted=guess.presorted)
    viols_i, out_sum, in_sum, mx, dups = torch.cat(
        [head, sniff_dev]).tolist()                         # the one readback
    est = sniff_stats_dict(mx, dups, chunk, k)
    window = dial_window(mx, chunk)
    est["windowEstimate"] = None if window >= (1 << 30) else window
    if viols_i:
        plan = pallas_plan(cfg, probing=False, window_override=window)
        fresh = banded_build_pipelined(r.keys, locality_window=plan.window,
                                       presort=plan.presort,
                                       presorted=plan.presorted)
        out = fresh._replace(violations=max(fresh.violations, viols_i),
                             resorted=True)
        pipe_ref = fresh
    else:
        plan = guess
        out = BandedJoinOutcome(0, 0, 0, out_sum, False, in_sum)
        pipe_ref = out
    elapsed_us = (time.perf_counter() - t0) * 1e6
    m = pallas_metrics(cfg, "htm", out, elapsed_us, None)
    _dial_remember(ck, r.keys, plan, est)
    _adaptive_metrics(m, plan, est, False)
    maybe_pipeline_timing(m, cfg, plan, r, None, pipe_ref)
    return m


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


def htm_join(r: Relation, s: Optional[Relation] = None,
             cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    if cfg.switch_sniff:
        return _htm_switch_join(r, s, cfg)
    if use_pallas_engine(cfg, s):
        return _htm_join_pallas(r, s, cfg)
    if (s is None or not cfg.enable_probe) and use_pallas_engine_build(cfg):
        return _htm_build_pallas(cfg, r)
    raise NotImplementedError(XLA_BUILD_TODO)


def _htm_switch_join(r: Relation, s: Optional[Relation],
                     cfg: JoinConfig) -> JoinMetrics:
    """HTM_SWITCH (config.h:16-17): a pre-pass samples the relation and
    measures firstRoundFailureFraction (HTMHashBuild.hpp:100-154); no
    locality switches the build to the radix join, the paper's
    low-overhead switch (README.md:6)."""
    from .adaptive import sniff_statistics
    from .radix import radix_join

    timer = PhaseTimer()
    dup_frac, max_key = sniff_statistics(r.keys, cfg, timer)
    use_htm = dup_frac < 0.004 and max_key <= 3 * htm_num_buckets(cfg.r_size)
    inner = dataclasses.replace(cfg, switch_sniff=False)
    if use_htm:
        m = htm_join(r, s, inner)
    else:
        m = radix_join(r, s, inner)
        m.algo = "htm"
        m.extra["switchedToRadix"] = True
    m.firstRoundTime = timer.micros.get("sniff", 0.0)
    m.firstRoundFailureFraction = float(dup_frac)
    return m


def _htm_build_pallas(cfg: JoinConfig, r: Relation) -> JoinMetrics:
    """Build-only banded path (ENABLE_PROBE off, the reference's default
    binary): the optimistic tile sort is the whole build; violations map to
    failedTransactions, the bitonic retry to TM_RETRY."""
    sniff = None
    if cfg.adaptive:
        if not cfg.track:
            return _htm_build_pallas_adaptive(cfg, r)
        # TM_TRACK needs the plan before its per-tile cause vectors join
        # the readback: the sniff-first variant
        plan, sniff = _adaptive_pallas_plan(r, cfg, probing=False)
    else:
        plan = pallas_plan(cfg, probing=False)
    t0 = time.perf_counter()
    res = banded_build_pipelined(r.keys, locality_window=plan.window,
                                 presort=plan.presort,
                                 presorted=plan.presorted,
                                 return_tile_violations=cfg.track)
    elapsed_us = (time.perf_counter() - t0) * 1e6
    if cfg.track:
        out, tile_viols, tile_dups = res
        m = pallas_metrics(cfg, "htm", out, elapsed_us, None)
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
    else:
        out = res
        m = pallas_metrics(cfg, "htm", out, elapsed_us, None)
    if sniff is not None:
        m.extra["adaptivePlan"] = _dialed_plan_extra(plan, sniff)
        m.extra["adaptiveTransactionSizeFinal"] = max(1, plan.window or 4096)
    maybe_pipeline_timing(m, cfg, plan, r, None, out)
    return m


def _htm_join_pallas(r: Relation, s: Relation, cfg: JoinConfig) -> JoinMetrics:
    """The banded engine as the HTM build+probe: one host readback on the
    fast path."""
    if cfg.adaptive:
        return _htm_join_pallas_adaptive(r, s, cfg)
    plan = pallas_plan(cfg)
    t0 = time.perf_counter()
    # permutation distributions certify both sides unique (S is generated
    # sorted 1..N)
    out = banded_join_pipelined(r.keys, s.keys, locality_window=plan.window,
                                presort=plan.presort,
                                presorted=plan.presorted, narrow=plan.narrow,
                                sort_s=not s.assume_sorted,
                                unique_both=keys_unique_both(cfg))
    elapsed_us = (time.perf_counter() - t0) * 1e6
    m = pallas_metrics(cfg, "htm", out, elapsed_us, out.matches)
    if cfg.track:
        # the join path's two failure modes: displacement violations of the
        # optimistic sorter, band overflow of the count
        m.extra["failureCauseDisplacement"] = out.violations
        m.extra["failureCauseBandOverflow"] = out.overflow_tiles
    maybe_pipeline_timing(m, cfg, plan, r, s, out)
    return m
