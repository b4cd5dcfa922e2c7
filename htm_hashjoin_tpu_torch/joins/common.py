"""Shared join-phase machinery: routing, the banded engine's planner, the
displacement sniff and dial, the scatter builds' spill, the metrics schema,
and the two drivers every join route ends in: ``engine_join`` (one call of
the banded engine on a ``BandedPlan``) and ``scatter_join`` (build a
scatter table, spill, probe).

Counterpart of ``htm_hashjoin_tpu/joins/common.py``.  Every join runs the
reference's phase protocol (build, then probe, with the host boundary as
the barrier); host-side branching happens exactly where the reference
branched between phases, on scalars read back in one bundle.

Routing differs from the JAX package by design in one place: ``auto``
means the banded engine on both devices (the kernels' plain versions on
CPU tensors, the kernels on CUDA tensors), where JAX takes its XLA
formulation on the CPU.  The scatter builds (``ops/insert.py``) therefore
run where JAX's run on its TPU: with ``backend="xla"``, on duplicate build
keys, and on keys at or above PACK_LIMIT.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..config import Distribution, JoinConfig
from ..constants import LANES, MAXI32, PACK_LIMIT
from ..relation import Relation, next_pow2
from ..ops import global_sort, insert, probe, radix_sort, sortops
from ..utils import timing
from ..utils.metrics import JoinMetrics
from ..utils.profiler import active_counters, span, traffic_counters
from ..utils.timing import PhaseTimer, readback
from .banded_backend import (DEFAULT_TILE, MAX_CHUNKS_DEFAULT,
                             banded_build_pipelined, banded_join_pipelined,
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


_IN_STEP = False   # a join step (join_scope) is open


def join_scope(join):
    """A ``joins.DISPATCH`` entry as one join step.  Its outermost call
    opens the ``hj.join`` span and writes the step's three counters into
    its line: ``readbacks``, the host's waits on the device
    (``utils.timing.READBACKS``), ``sortedKeys``, the keys K3 was given
    (``ops.global_sort.SORTED_KEYS``), and ``claimRows``, the rows handed
    to the scatter builds' claim step (``ops.insert.CLAIM_ROWS``), each
    read as a difference over the step.  A call inside the step
    (``adaptive_join`` calls ``htm_join`` or ``radix_join``) is part of it
    and opens nothing."""
    @functools.wraps(join)
    def step(*args, **kwargs):
        global _IN_STEP
        if _IN_STEP:
            return join(*args, **kwargs)
        _IN_STEP = True
        reads, keys = timing.READBACKS, global_sort.SORTED_KEYS
        claims = insert.CLAIM_ROWS
        try:
            with span("hj.join"):
                m = join(*args, **kwargs)
                m.extra["readbacks"] = timing.READBACKS - reads
                m.extra["sortedKeys"] = global_sort.SORTED_KEYS - keys
                m.extra["claimRows"] = insert.CLAIM_ROWS - claims
                return m
        finally:
            _IN_STEP = False
    return step


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


def table_size_for(cfg: JoinConfig) -> int:
    """Flat-table size: scaleOutput x rSize rounded up to a power of two
    (AtomicHashBuild.hpp:21-25)."""
    return next_pow2(max(2, cfg.scale_output * cfg.r_size))


def htm_num_buckets(r_size: int) -> int:
    """numBuckets = next_pow2(rSize/3 + 1) (HTMHashBuild.hpp:61-62)."""
    return next_pow2(r_size // 3 + 1)


class SpillState:
    """The tuples a scatter build did not place: the conflicts-array analog
    (HTMHashBuild.hpp:79-83, AtomicHashBuild.hpp:62-63), kept searchable so
    that the probe still sees every build tuple (the reference's probe
    ignored its conflict arrays).

    One readback gives the spill's count and key sum, and the values of the
    device scalars ``head`` (the build's own sums), in ``self.head``.  Only
    a non-empty spill is compacted and sorted (``insert.spill_sorted``),
    so its probe counts exactly what the spill holds: the JAX package
    searches an R-sized array padded with INT32_MAX (ROADMAP queue 3,
    reference fault 8).  The probe searches the sorted spill for each S
    key (``sortops.merge_count``), where JAX re-sorts both as tagged
    composites.

    ``scatter_join`` makes it inside its ``hj.build`` span and calls
    ``probe_count`` inside its ``hj.probe`` span."""

    def __init__(self, keys: torch.Tensor, pending: torch.Tensor,
                 timer: PhaseTimer, head=()):
        stats = readback(torch.stack([
            torch.sum(pending, dtype=torch.int64),
            probe.masked_sum(keys, pending),
            *(h.to(torch.int64) for h in head)]))
        self.count, self.key_sum, *self.head = stats
        self._spill: Optional[torch.Tensor] = None
        if self.count > 0:
            self._spill = timer.timed(
                "spill", lambda: insert.spill_sorted(keys, pending)[0])

    def probe_count(self, skeys: torch.Tensor, timer: PhaseTimer) -> int:
        """Matches of ``skeys`` against the spill (multiset-exact)."""
        if self._spill is None:
            return 0
        return readback(timer.timed("probe_spill", sortops.merge_count,
                                    self._spill, skeys))


def finish_metrics(m: JoinMetrics, timer: PhaseTimer,
                   total_matches: Optional[int],
                   retry: bool = False) -> JoinMetrics:
    """Fold a timed run into the metrics: the build phase (with the spill)
    and the probe phase (with the spill's probe), the match count, and the
    failure fractions (``failure_fractions``).  The timed phases' counters
    (``--counters``) go into the line as ``counters``, the reference's
    per-phase PCM dumps (no_partitioning_join.c:458-527)."""
    with span("hj.line"):
        if timer.counters:
            m.extra["counters"] = timer.counters
        micros = timer.micros
        m.hashBuildTimeInMicroseconds = (micros.get("build", 0.0)
                                         + micros.get("spill", 0.0))
        if "probe" in micros or "probe_spill" in micros:
            m.probeTimeInMicroseconds = (micros.get("probe", 0.0)
                                         + micros.get("probe_spill", 0.0))
        if total_matches is not None:
            m.totalMatches = total_matches
        failure_fractions(m, retry)
        return m


def failure_fractions(m: JoinMetrics, retry: bool) -> None:
    """The failure fractions (fractions despite the names, the reference's
    own convention, HTMHashBuild.hpp:410-415); under TM_RETRY
    totalFailedPercentage counts only the residual conflicts."""
    if m.rSize:
        m.failedTransactionPercentage = m.failedTransactions / m.rSize
        m.totalFailedPercentage = (
            m.conflictCount / m.rSize if retry else
            (m.failedTransactions + m.conflictCount) / m.rSize)


def probes(s: Optional[Relation], cfg: JoinConfig) -> bool:
    """The join has a probe side: without one it builds only."""
    return s is not None and cfg.enable_probe


def resolve_relations(r: Relation, s: Optional[Relation], cfg: JoinConfig
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    return r.keys, (s.keys if probes(s, cfg) else None)


# ---------------------------------------------------------------------------
# Banded-engine routing and plan selection
# ---------------------------------------------------------------------------

def _max_key_bound(cfg: JoinConfig) -> int:
    """Upper bound on key values from the generator contract; RANDOM draws
    the full int32 range."""
    if cfg.data_distr == Distribution.RANDOM:
        return MAXI32
    return max(cfg.r_size, cfg.s_size or 0, cfg.distinct_keys or 0)


def _build_key_bound(cfg: JoinConfig) -> int:
    """Upper bound on the build side's (R's) key values from the generator
    contract: R is drawn from 1..|R| or from the alphabet ``distinct_keys``
    (``data/generators.build_relations``); RANDOM draws the full int32
    range."""
    if cfg.data_distr == Distribution.RANDOM:
        return MAXI32
    return max(cfg.r_size, cfg.distinct_keys or 0)


def use_pallas_engine(cfg: JoinConfig, s: Optional[Relation]) -> bool:
    """The banded engine qualifies for a build+probe: a probe side, keys
    below PACK_LIMIT (the kernels count only those), no mesh, and a backend
    other than ``xla``."""
    if cfg.backend == "xla" or cfg.mesh_shape or not probes(s, cfg):
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


def route_unique_pallas(cfg: JoinConfig, s: Optional[Relation]) -> bool:
    """Routing of the identity-hash builds (atomic, nocc): the banded
    engine only on generator-certified unique keys, probing or not."""
    if probes(s, cfg):
        return keys_are_unique(cfg) and use_pallas_engine(cfg, s)
    return use_pallas_engine_build(cfg)


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


def adaptive_window_estimate(rkeys: torch.Tensor, cfg: JoinConfig) -> dict:
    """HTM_ADAPT's observation step (HTMHashBuild.hpp:196-211): sample
    sniff_rounds strided chunks of sniff_chunk keys, measure their
    displacement profile on the device (one readback), and return the
    statistics that pick the engine's sorter."""
    chunk, k = _sniff_shape(rkeys.numel(), cfg)
    t0 = time.perf_counter()
    with span("hj.sniff"):
        stats = _sniff_profile(rkeys, chunk, k)
    mx, dups = readback(stats)                             # the one readback
    sniff_us = (time.perf_counter() - t0) * 1e6
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
    with span("hj.sniff"):
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
# Metrics and the --counters traffic model
# ---------------------------------------------------------------------------

def radix_sort_bytes(n: int) -> float:
    """Device-memory bytes the radix sort behind K3 moves over n int32 keys
    (``csrc/radix_sort.cu``): one read for the digit histograms, then
    ``radix_sort.PASSES`` scatter passes that each read and write every
    key."""
    return 4.0 * n * (1 + 2 * radix_sort.PASSES)


def plan_traffic_bytes(cfg: JoinConfig, plan: BandedPlan, probing: bool,
                       sort_s: bool) -> float:
    """Modelled device-memory bytes of the banded engine for this plan:

      * presorted build: one R read (stats and conservation);
      * tile-sort build: one R stream (read + write);
      * presort build:   K3's radix sort of R (``radix_sort_bytes``);
      * probing count:   sorted R re-read + one S-band pass;
      * sort_s:          K3's radix sort of S.

    The JAX package's model (``common.py:319-349``) counts its bitonic
    global sort's passes where this one counts K3's.  K1 sorts and counts
    in one read of R, so on the narrow plans the model is an upper bound
    by one R round trip."""
    rb = 4.0 * cfg.r_size
    sb = 4.0 * (cfg.s_size or 0)
    if plan.presorted:
        byts = rb
    elif plan.presort:
        byts = radix_sort_bytes(cfg.r_size)
    else:
        byts = 2.0 * rb
    if probing:
        byts += rb + sb
        if sort_s:
            byts += radix_sort_bytes(cfg.s_size or 0)
    return byts


def pallas_metrics(cfg: JoinConfig, algo: str, outcome, elapsed_us: float,
                   matches: Optional[int], plan: BandedPlan,
                   sort_s: bool = False) -> JoinMetrics:
    """Fold a BandedJoinOutcome into the reference metrics schema (the
    ``backend`` name stays the JAX package's, so that lines compare).

    ``plan`` (the plan the join ran) and ``sort_s`` (whether it sorted S on
    the device) feed the ``--counters`` traffic model: with a counter
    session on, the plan's modelled traffic over the join's time goes into
    the line as ``counters``."""
    with span("hj.line"):
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
        if active_counters() is not None:
            probing = matches is not None
            m.extra["counters"] = {("build+probe" if probing else "build"):
                                   traffic_counters(plan_traffic_bytes(
                                       cfg, plan, probing, sort_s),
                                       elapsed_us)}
        failure_fractions(m, cfg.retry)
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
    with span("hj.line"):
        s2d = None
        if s is not None and s.assume_sorted:
            # sorted S is tiled and padded once and reused (an input, not
            # per-join work); unsorted S keeps its device sort in the chain
            s2d = prepare_probe_side(s.keys)
            readback(s2d[:1])   # resident before timing starts
        t0 = time.perf_counter()
        if s is not None:
            for _ in range(depth):
                res = enqueue_full_join(r.keys, s.keys,
                                        **plan_args(plan, cfg, s), s2d=s2d)
            readback(torch.stack(res[:5]))           # one fence for the batch
        else:
            for _ in range(depth):
                head = enqueue_banded_build(r.keys, **plan_args(plan))
            readback(head)
        per_point_us = (time.perf_counter() - t0) * 1e6 / depth
        m.extra["singleRunTimeInMicroseconds"] = m.hashBuildTimeInMicroseconds
        m.extra["pipelineDepth"] = depth
        m.hashBuildTimeInMicroseconds = per_point_us


# ---------------------------------------------------------------------------
# The engine driver: one call of the banded engine on a plan
# ---------------------------------------------------------------------------

def plan_args(plan: BandedPlan, cfg: Optional[JoinConfig] = None,
              s: Optional[Relation] = None) -> dict:
    """The engine's keyword arguments for ``plan``: the build's, and with a
    probe side ``s`` the join's (S sorted on the device unless it is
    certainly sorted; both sides unique where the generator certifies
    it)."""
    args = dict(locality_window=plan.window, presort=plan.presort,
                presorted=plan.presorted)
    if s is not None:
        args.update(narrow=plan.narrow, sort_s=not s.assume_sorted,
                    unique_both=keys_unique_both(cfg))
    return args


def _engine(r: Relation, s: Optional[Relation], cfg: JoinConfig,
            plan: BandedPlan):
    """The engine on ``plan``, the join or (no probe side) the build, with
    its one readback on the fast path: (outcome, elapsed microseconds)."""
    t0 = time.perf_counter()
    if probes(s, cfg):
        out = banded_join_pipelined(r.keys, s.keys, **plan_args(plan, cfg, s))
    else:
        out = banded_build_pipelined(r.keys, **plan_args(plan))
    return out, (time.perf_counter() - t0) * 1e6


def engine_line(algo: str, r: Relation, s: Optional[Relation],
                cfg: JoinConfig, plan: BandedPlan, out, elapsed_us: float,
                fields: Optional[Callable[[JoinMetrics], None]] = None,
                pipe_ref=None, sustained: bool = True) -> JoinMetrics:
    """The engine's line in an ``hj.line`` span: ``pallas_metrics`` of
    ``out``, the route's own ``fields(m)``, then, where the route has it
    (``sustained``), the sustained timing (``maybe_pipeline_timing``)
    unless ``pipe_ref``, the run it repeats (default ``out``), retried or
    repaired."""
    probing = probes(s, cfg)
    with span("hj.line"):
        m = pallas_metrics(cfg, algo, out, elapsed_us,
                           out.matches if probing else None, plan=plan,
                           sort_s=probing and not s.assume_sorted)
        if fields is not None:
            fields(m)
        if sustained:
            maybe_pipeline_timing(m, cfg, plan, r, s if probing else None,
                                  out if pipe_ref is None else pipe_ref)
        return m


def engine_join(algo: str, r: Relation, s: Optional[Relation],
                cfg: JoinConfig, plan: Optional[BandedPlan] = None,
                fields: Optional[Callable[[JoinMetrics], None]] = None,
                sustained: bool = True) -> JoinMetrics:
    """A join as one call of the banded engine on ``plan`` (default: the
    planner's, ``pallas_plan``), the join or, without a probe side, the
    build; the engine call and its line are the planner's ``hj.plan``
    span.  ``fields(m)`` adds the route's own fields to the line;
    ``sustained`` off leaves out the sustained timing (npo, as in JAX)."""
    with span("hj.plan"):
        if plan is None:
            plan = pallas_plan(cfg, probing=probes(s, cfg))
        out, elapsed_us = _engine(r, s, cfg, plan)
        return engine_line(algo, r, s, cfg, plan, out, elapsed_us, fields,
                           sustained=sustained)


def unique_table_fields(m: JoinMetrics) -> None:
    """The line of the identity-hash builds (atomic, nocc) when the engine
    runs them on generator-certified unique build keys.  The
    open-addressing table at 2x load loses and spills nothing there (keys
    1..n take distinct slots under key & (2n-1)), so conflicts and
    failedTransactions are 0 in both formulations, whatever tiles a skewed
    S flags in the engine's count; the engine gives the same matches and
    sums (an unsorted or duplicate-heavy S takes the device sort and the
    general count)."""
    m.conflictCount = m.failedTransactions = 0
    m.failedTransactionPercentage = m.totalFailedPercentage = 0.0


# ---------------------------------------------------------------------------
# The scatter driver: build a table, spill, probe
# ---------------------------------------------------------------------------

def _summed_build(build, keys: torch.Tensor):
    """``build(keys)``, then the sums conservation compares: the table's
    keys and the input's."""
    table, pending, *extra = build(keys)
    return (table, pending, *extra, probe.table_sum(table),
            torch.sum(keys, dtype=torch.int64))


def scatter_join(algo: str, r: Relation, s: Optional[Relation],
                 cfg: JoinConfig, build, probe_table, *,
                 probe_spill: bool = True, fields=None) -> JoinMetrics:
    """A scatter table's join (atomic, nocc, npo, htm's scatter route):
    the timed build and its spill (``SpillState``) in ``hj.build``; the
    timed probe of the table and, unless ``probe_spill`` is off (nocc,
    whose conflicts feed outputSum only), of the spill in ``hj.probe``;
    then the line (``finish_metrics``).

    ``build(rkeys)`` returns (table, pending, *extra): ``extra`` are int64
    device scalars that ride the spill's readback and reach
    ``fields(m, *extra)`` as numbers, which adds the algorithm's own fields
    to the line.  ``probe_table(table, skeys)`` returns the table's match
    count as a device scalar."""
    rkeys, skeys = resolve_relations(r, s, cfg)
    timer = PhaseTimer()
    with span("hj.build"):
        table, pending, *head = timer.timed("build", _summed_build, build,
                                            rkeys)
        spill = SpillState(rkeys, pending, timer, head=head)
    *extra, table_sum, in_sum = spill.head
    matches = None
    if skeys is not None:
        with span("hj.probe"):
            matches = readback(timer.timed("probe", probe_table, table,
                                           skeys))
            if probe_spill:
                matches += spill.probe_count(skeys, timer)
    m = JoinMetrics(algo=algo, rSize=cfg.r_size,
                    transactionSize=cfg.transaction_size,
                    probeLength=cfg.probe_length, conflictCount=spill.count,
                    inputSum=in_sum, outputSum=table_sum + spill.key_sum)
    if fields is not None:
        fields(m, *extra)
    return finish_metrics(m, timer, matches, retry=cfg.retry)
