"""Shared join-phase machinery: routing, the banded engine's planner, the
displacement sniff and dial, and the metrics schema.

Counterpart of ``htm_hashjoin_tpu/joins/common.py``.  Every join runs the
reference's phase protocol (build, then probe, with the host boundary as
the barrier); host-side branching happens exactly where the reference
branched between phases, on scalars read back in one bundle.

Routing differs from the JAX package by design in one place: ``auto``
means the banded engine on both devices (the kernels' plain versions on
CPU tensors, the kernels on CUDA tensors), where JAX takes its XLA
formulation on the CPU.  Not ported yet: ``SpillState``,
``pallas_unique_join`` and ``route_unique_pallas`` (the atomic/nocc builds,
ROADMAP queue 1 item 7), ``plan_traffic_bytes`` and ``_gsort_pass_count``
(the ``--counters`` model, item 9).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import Distribution, JoinConfig
from ..constants import LANES, MAXI32, PACK_LIMIT
from ..relation import Relation, next_pow2
from ..utils.metrics import JoinMetrics
from ..utils.timing import PhaseTimer
from .banded_backend import (DEFAULT_TILE, MAX_CHUNKS_DEFAULT,
                             enqueue_banded_build, enqueue_full_join,
                             prepare_probe_side)

# Distributions whose keys are an exact permutation of 1..N (unique).
_UNIQUE_DISTS = frozenset({
    Distribution.SORTED, Distribution.SHUFFLE, Distribution.LOCAL_SHUFFLE,
    Distribution.PK, Distribution.PK_LSHUFFLE,
})

# The widest locality window the wide-band plan takes: a tile's band spans
# about T + 2w keys, which K4 must cover inline in max_chunks tile-sized
# chunks plus a row, (T + 2w + 128) / T <= max_chunks.  The JAX package's
# bound is its tile, 65536; at the port's tile 8192 and 16 chunks it is
# 61,376.
WIDE_BAND_MAX = ((MAX_CHUNKS_DEFAULT - 1) * DEFAULT_TILE - LANES) // 2


def keys_are_unique(cfg: JoinConfig) -> bool:
    return cfg.data_distr in _UNIQUE_DISTS


def keys_unique_both(cfg: JoinConfig) -> bool:
    """Both sides certified unique (R-side uniqueness alone is not enough:
    a duplicate-heavy S, zipf/nonunique or fk with s_size > r_size, has
    repeated keys)."""
    if not keys_are_unique(cfg):
        return False
    if cfg.s_distr is None or cfg.s_distr == Distribution.SORTED:
        return True   # driver rule: S = sorted 1..s_size (unique)
    if cfg.s_distr == Distribution.FK:
        # fk multiplicity is ceil(s/r): unique iff s_size <= r_size
        return (cfg.s_size or 0) <= cfg.r_size
    return False


def htm_num_buckets(r_size: int) -> int:
    """numBuckets = next_pow2(rSize/3 + 1) (HTMHashBuild.hpp:61-62)."""
    return next_pow2(r_size // 3 + 1)


def finish_metrics(m: JoinMetrics, timer: PhaseTimer,
                   total_matches: Optional[int]) -> JoinMetrics:
    """Fold a timed run into the metrics: build and probe phase times, the
    match count, and the failure fractions (fractions despite the names,
    the reference's own convention, HTMHashBuild.hpp:410-415).  The JAX
    function also folds the spill phases and TM_RETRY's rule of its XLA
    scatter build, which is not ported."""
    m.hashBuildTimeInMicroseconds = timer.micros.get("build", 0.0)
    if "probe" in timer.micros:
        m.probeTimeInMicroseconds = timer.micros["probe"]
    if total_matches is not None:
        m.totalMatches = total_matches
    if m.rSize:
        m.failedTransactionPercentage = m.failedTransactions / m.rSize
        m.totalFailedPercentage = ((m.failedTransactions + m.conflictCount)
                                   / m.rSize)
    return m


def resolve_relations(r: Relation, s: Optional[Relation], cfg: JoinConfig
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    skeys = s.keys if (s is not None and cfg.enable_probe) else None
    return r.keys, skeys


# ---------------------------------------------------------------------------
# Banded-engine routing and plan selection
# ---------------------------------------------------------------------------

def _max_key_bound(cfg: JoinConfig) -> int:
    """Upper bound on key values from the generator contract; RANDOM draws
    the full int32 range."""
    if cfg.data_distr == Distribution.RANDOM:
        return MAXI32
    return max(cfg.r_size, cfg.s_size or 0, cfg.distinct_keys or 0)


def use_pallas_engine(cfg: JoinConfig, s: Optional[Relation]) -> bool:
    """The banded engine qualifies for a build+probe: a probe side, keys
    below PACK_LIMIT (the kernels count only those), no mesh, and a backend
    other than ``xla``."""
    if cfg.backend == "xla" or cfg.mesh_shape:
        return False
    if s is None or not cfg.enable_probe:
        return False
    return _max_key_bound(cfg) < PACK_LIMIT


def use_pallas_engine_build(cfg: JoinConfig) -> bool:
    """Banded-engine routing for build-only runs (the reference's default
    ENABLE_PROBE=off binaries), on generator-certified unique keys: there
    the scatter builds lose and spill nothing, so the sorted-tile artifact
    is observationally the same."""
    if cfg.backend == "xla" or cfg.mesh_shape:
        return False
    return keys_are_unique(cfg) and _max_key_bound(cfg) < PACK_LIMIT


class BandedPlan(NamedTuple):
    """Engine plan for one join (compares equal to a plain tuple)."""
    window: Optional[int]    # optimistic sorter window (None = exact)
    presort: bool            # global sort first (the radix-path plan)
    presorted: bool          # input certified sorted: no sort at all
    narrow: Optional[bool]   # narrow-count override (None = engine default)


def pallas_plan(cfg: JoinConfig, probing: bool = True,
                window_override: Optional[int] = None) -> BandedPlan:
    """Plan selection for the banded engine, by locality regime:

    * certified sorted input  -> no sort at all (presorted);
    * window <= 512           -> optimistic bounded-displacement sorter
      (odd-even / shifted-block; 512 is the sorters' reach and the narrow
      count's certified overhang);
    * window <= WIDE_BAND_MAX -> exact per-tile bitonic with wide bands,
      which the general count (K4) covers inline;
    * beyond, and duplicate-key/global distributions -> sort-first, except
      build-only (``probing=False``), where per-tile sorted runs are
      already a probe-able artifact.

    ``window_override`` (the dial): a measured displacement bound replaces
    the declared window; 0 runs the 1-pass optimistic sorter (a sample
    cannot certify global sortedness)."""
    w = window_override
    if w is None:
        if cfg.data_distr == Distribution.SORTED:
            return BandedPlan(1, False, True, None)
        if cfg.data_distr in (Distribution.LOCAL_SHUFFLE,
                              Distribution.PK_LSHUFFLE):
            w = cfg.shuffle_range
    elif w == 0:
        w = 1
    if w is not None:
        if w <= 512:
            return BandedPlan(max(1, w), False, False, None)
        if w <= WIDE_BAND_MAX:
            return BandedPlan(None, False, False, False)
    if not probing:
        return BandedPlan(None, False, False, False)
    return BandedPlan(None, True, False, None)


# ---------------------------------------------------------------------------
# The displacement sniff and the dial (HTM_ADAPT)
# ---------------------------------------------------------------------------

def _sniff_shape(n: int, cfg: JoinConfig) -> tuple[int, int]:
    """(chunk, k): k strided chunks of the reference's K x 16384 shape."""
    chunk = min(cfg.sniff_chunk, max(8, n // max(1, cfg.sniff_rounds)))
    return chunk, max(1, min(cfg.sniff_rounds, n // chunk))


def _sniff_profile(keys: torch.Tensor, chunk: int, k: int) -> torch.Tensor:
    """[max in-chunk displacement, adjacent duplicates] (int64, on the
    keys' device) over k strided chunks of ``chunk`` keys: each key's
    distance from its place in its chunk's stable sort."""
    n = keys.numel()
    stride = n // k
    starts = torch.arange(k, device=keys.device) * stride
    idx = starts[:, None] + torch.arange(chunk, device=keys.device)[None, :]
    segs = keys[idx.clamp_(max=max(0, n - 1))]
    sseg, order = torch.sort(segs, dim=1, stable=True)
    pos = torch.arange(chunk, device=keys.device).expand(k, chunk)
    disp = (order - pos).abs()
    dups = (sseg[:, 1:] == sseg[:, :-1]).sum()
    return torch.stack([disp.amax().to(torch.int64), dups.to(torch.int64)])


def adaptive_window_estimate(rkeys: torch.Tensor, cfg: JoinConfig,
                             timer=None) -> dict:
    """HTM_ADAPT's observation step (HTMHashBuild.hpp:196-211): sample
    sniff_rounds strided chunks of sniff_chunk keys, measure their
    displacement profile on the device (one readback), and return the
    statistics that pick the engine's sorter."""
    chunk, k = _sniff_shape(rkeys.numel(), cfg)
    t0 = time.perf_counter()
    mx, dups = _sniff_profile(rkeys, chunk, k).tolist()   # the one readback
    sniff_us = (time.perf_counter() - t0) * 1e6
    if timer is not None:
        timer.micros["sniff"] = timer.micros.get("sniff", 0.0) + sniff_us
    return {"maxDisplacement": mx, "sampleDuplicates": dups,
            "sniffTimeUs": sniff_us, "sampleChunks": k,
            "sampleChunkSize": chunk,
            "dupFraction": dups / max(1, k * chunk)}


def adaptive_guess_plan(cfg: JoinConfig, probing: bool = True) -> BandedPlan:
    """The fused dial's optimistic first plan: a declared optimistic plan
    (window <= 512) or certified sorted input is trusted (its violation
    count catches a lying config); anything wider runs the widest
    optimistic sorter (blocks-512), exact for any true window <= 512.  If
    the data is really disordered, the violations in the shared readback
    trigger the repair run, planned from the sniffed displacement."""
    base = pallas_plan(cfg, probing=probing)
    if base.presorted or (base.window is not None and base.window <= 512
                          and not base.presort):
        return base
    return BandedPlan(512, False, False, None)


def sniff_enqueue(rkeys: torch.Tensor, cfg: JoinConfig):
    """Enqueue the displacement sniff without a fence.  Returns (device
    stats [maxDisplacement, sampleDuplicates] int64, chunk, k): stack the
    stats into the join's own readback."""
    chunk, k = _sniff_shape(rkeys.numel(), cfg)
    return _sniff_profile(rkeys, chunk, k), chunk, k


def sniff_stats_dict(mx: int, dups: int, chunk: int, k: int) -> dict:
    """The adaptive_window_estimate stats of a sniff whose readback rode
    the engine's (sniffTimeUs 0: no separate host round trip)."""
    return {"maxDisplacement": mx, "sampleDuplicates": dups,
            "sniffTimeUs": 0.0, "sniffRodeEngineFence": True,
            "sampleChunks": k, "sampleChunkSize": chunk,
            "dupFraction": dups / max(1, k * chunk)}


def dial_window(mx: int, chunk: int) -> int:
    """The dial (HTMHashBuild.hpp:208-210 analog): in-chunk displacement
    near the chunk size means disorder beyond the sample's reach, so the
    plan escalates to sort-first."""
    return (1 << 30) if mx >= chunk // 2 else mx


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def pallas_metrics(cfg: JoinConfig, algo: str, outcome, elapsed_us: float,
                   matches: Optional[int]) -> JoinMetrics:
    """Fold a BandedJoinOutcome into the reference metrics schema (the
    ``backend`` name stays the JAX package's, so that lines compare)."""
    m = JoinMetrics(algo=algo, rSize=cfg.r_size,
                    transactionSize=cfg.transaction_size,
                    probeLength=cfg.probe_length,
                    conflictCount=outcome.overflow_tiles,
                    failedTransactions=outcome.violations,
                    inputSum=outcome.input_sum,
                    outputSum=outcome.output_sum,
                    hashBuildTimeInMicroseconds=elapsed_us)
    if matches is not None:
        m.totalMatches = matches
    m.extra["backend"] = "pallas_banded"
    m.extra["resorted"] = outcome.resorted
    if cfg.r_size:
        # fractions, with the TM_RETRY rule (HTMHashBuild.hpp:410-415)
        m.failedTransactionPercentage = m.failedTransactions / cfg.r_size
        m.totalFailedPercentage = (
            m.conflictCount / cfg.r_size if cfg.retry else
            (m.failedTransactions + m.conflictCount) / cfg.r_size)
    return m


def maybe_pipeline_timing(m: JoinMetrics, cfg: JoinConfig, plan: BandedPlan,
                          r: Relation, s: Optional[Relation], out) -> None:
    """Sustained-throughput timing (cfg.pipeline_depth > 1): enqueue the
    same join pipeline_depth times and fence once, replacing
    hashBuildTimeInMicroseconds; the single-run time stays in the line as
    singleRunTimeInMicroseconds.  Only on clean fast paths: a run that
    retried or repaired keeps its repair cost in the reported time."""
    depth = cfg.pipeline_depth
    if depth <= 1 or out.resorted or out.violations or out.overflow_tiles:
        return
    s2d = None
    if s is not None and s.assume_sorted:
        # sorted S is tiled and padded once and reused (an input, not
        # per-join work); unsorted S keeps its device sort in the chain
        s2d = prepare_probe_side(s.keys)
        s2d[:1].tolist()   # resident before timing starts
    t0 = time.perf_counter()
    if s is not None:
        for _ in range(depth):
            res = enqueue_full_join(r.keys, s.keys,
                                    locality_window=plan.window,
                                    presort=plan.presort,
                                    presorted=plan.presorted,
                                    narrow=plan.narrow,
                                    sort_s=not s.assume_sorted,
                                    unique_both=keys_unique_both(cfg),
                                    s2d=s2d)
        torch.stack(res[:5]).tolist()            # one fence for the batch
    else:
        for _ in range(depth):
            head = enqueue_banded_build(r.keys, locality_window=plan.window,
                                        presort=plan.presort,
                                        presorted=plan.presorted)
        head.tolist()
    per_point_us = (time.perf_counter() - t0) * 1e6 / depth
    m.extra["singleRunTimeInMicroseconds"] = m.hashBuildTimeInMicroseconds
    m.extra["pipelineDepth"] = depth
    m.hashBuildTimeInMicroseconds = per_point_us
