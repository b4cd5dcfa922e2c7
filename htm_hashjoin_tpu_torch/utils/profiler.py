"""Observability: the reference's profiling tiers on PyTorch.

Counterpart of ``htm_hashjoin_tpu/utils/profiler.py``.  Reference tier ->
here:

  1. gettimeofday phase spans (HTMHashBuild.hpp:93-94,310)
       -> ``PhaseTimer`` (timing.py), ending each phase in a synchronize.
  2. rdtsc cycles + cycles-per-tuple (mc/src/rdtsc.h:35-57; print_timing,
     mc/src/no_partitioning_join.c:313-333)
       -> ``throughput_report``: ns/tuple and tuples/s.  No cycles/tuple:
          the card's clock moves under load and power limit, and ns/tuple
          carries the same measurement.
  3. Intel PCM hardware counters, 4 events programmed from pcm.cfg
     (mc/src/perf_counters.c:60-107, mc/pcm.cfg)
       -> ``PerfCounters``: named events over a cost model, programmed from
          the same name=key config-file shape.  torch has no XLA cost
          model, so the port's model is its own: a timed phase accesses the
          bytes of the tensors it takes and returns (a lower bound: each
          input read once, each output written once), the banded engine's
          the bytes its plan streams (``joins/common.plan_traffic_bytes``),
          and ``flops`` is 0 (the joins do no work torch's flop counter
          counts).  ``arithmetic_intensity`` and ``hbm_gbps`` are derived
          as in JAX; unknown keys read 0.
  4. --enable-syncstats per-thread barrier wait times
     (mc/src/parallel_radix_join.c:81-106,1256-1277)
       -> ``sync_stats`` and ``shard_work_from_histogram``.

``trace()`` wraps torch.profiler: a Chrome trace of the host and, with a
card present, its kernels, written into a directory (the reference's
per-phase PCM dumps).  ``span(name)`` marks a stretch of the join's host
work in that trace (the ``hj.*`` spans, ``SPANS``), on the clock of the
card's activity, and costs one flag read while no profiler records.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


# ---------------------------------------------------------------------------
# Tier 2: throughput reporting
# ---------------------------------------------------------------------------

def throughput_report(num_tuples: int, micros: float) -> Dict[str, float]:
    """print_timing analog (mc/src/no_partitioning_join.c:313-333): total
    time, ns/tuple, tuples/s."""
    return {
        "numTuples": num_tuples,
        "totalTimeUsecs": micros,
        "nsPerTuple": (micros * 1e3 / num_tuples) if num_tuples else 0.0,
        "tuplesPerSecond": (num_tuples / (micros * 1e-6)) if micros else 0.0,
    }


# ---------------------------------------------------------------------------
# Tier 3: PCM-analog counters
# ---------------------------------------------------------------------------

def tensor_bytes(*items) -> int:
    """Bytes of the tensors among ``items``, tuples, lists and dict values
    opened."""
    total = 0
    for x in items:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            total += tensor_bytes(*x)
        elif isinstance(x, dict):
            total += tensor_bytes(*x.values())
    return total


class PerfCounters:
    """Programmable counter set (perf_counters.c:78-104 analog).

    Events are ``name=key`` lines naming cost-model entries (``flops``,
    ``bytes accessed``) or the two derived keys, ``arithmetic_intensity``
    (flops / bytes accessed) and ``hbm_gbps`` (bytes accessed / measured
    seconds, given as ``micros``).  Like the reference's 4-event limit,
    unknown keys read 0."""

    #: mc/pcm.cfg ships DTLB/L3 miss events; the device-meaningful defaults:
    DEFAULT_EVENTS = {
        "flops": "flops",
        "bytes": "bytes accessed",
        "intensity": "arithmetic_intensity",
        "bandwidth": "hbm_gbps",
    }

    def __init__(self, events: Optional[Dict[str, str]] = None):
        self.events = dict(events or self.DEFAULT_EVENTS)

    @classmethod
    def from_config(cls, path: str) -> "PerfCounters":
        """Load ``name=key`` lines (the pcm.cfg shape: one event per line,
        '#' comments)."""
        events: Dict[str, str] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                name, _, key = line.partition("=")
                events[name.strip()] = key.strip()
        return cls(events)

    def read(self, bytes_moved: float, micros: Optional[float],
             flops: float = 0.0) -> Dict[str, float]:
        """The events over a cost of ``flops`` and ``bytes_moved`` taking
        ``micros`` (no time: bandwidth 0)."""
        model = {
            "flops": flops,
            "bytes accessed": bytes_moved,
            "arithmetic_intensity": flops / bytes_moved if bytes_moved else 0.0,
            "hbm_gbps": (bytes_moved / (micros * 1e-6) / 1e9)
                        if (micros and bytes_moved) else 0.0,
        }
        return {name: float(model.get(key, 0.0))
                for name, key in self.events.items()}

    def measure(self, fn, *args, micros: Optional[float] = None,
                **kwargs) -> Dict[str, float]:
        """Run ``fn`` once and read the events over the bytes of the
        tensors it takes and returns; bandwidth needs ``micros``."""
        out = fn(*args, **kwargs)
        return self.read(tensor_bytes(args, kwargs, out), micros)


# ---------------------------------------------------------------------------
# Per-phase counter session (the PCM start/stop-around-each-phase hooks,
# mc/src/no_partitioning_join.c:458-527).  Enabled by the CLI's and the
# harness's --counters flag; PhaseTimer.timed records each phase into it,
# and the banded engine's joins record their plan's traffic.
# ---------------------------------------------------------------------------

_ACTIVE: Optional[PerfCounters] = None


def enable_counters(pc: Optional[PerfCounters] = None) -> None:
    global _ACTIVE
    _ACTIVE = pc or PerfCounters()


def disable_counters() -> None:
    global _ACTIVE
    _ACTIVE = None


def active_counters() -> Optional[PerfCounters]:
    return _ACTIVE


def phase_counters_from_fn(args, kwargs, out,
                           micros: float) -> Optional[Dict[str, float]]:
    """Counters of a timed phase: the bytes of the tensors its fn took
    (``args``, ``kwargs``) and returned (``out``) over ``micros``.  None
    when no counter session is on."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.read(tensor_bytes(args, kwargs, out), micros)


def traffic_counters(bytes_moved: float, micros: float,
                     flops: float = 0.0) -> Optional[Dict[str, float]]:
    """Counters of a banded-engine join from its plan's modelled traffic.
    None when no counter session is on."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.read(bytes_moved, micros, flops)


# ---------------------------------------------------------------------------
# Tier 4: syncstats — barrier wait breakdown
# ---------------------------------------------------------------------------

def sync_stats(work_per_shard: Sequence[float]) -> Dict[str, Any]:
    """Predicted per-shard barrier waits under lockstep
    (--enable-syncstats analog, parallel_radix_join.c:81-106).

    The reference measures actual pthread barrier wait times; here the wait
    is determined by load imbalance: the max-work shard sets the barrier,
    every other shard waits (max - own).  Returns the per-shard waits plus
    the imbalance fraction (wasted device-time share).
    """
    w = np.asarray(work_per_shard, dtype=np.float64)
    if w.size == 0 or w.max() == 0:
        return {"waits": w.tolist(), "imbalance": 0.0, "criticalShard": -1}
    waits = (w.max() - w)
    return {
        "waits": waits.tolist(),
        "imbalance": float(waits.sum() / (w.max() * w.size)),
        "criticalShard": int(np.argmax(w)),
    }


def shard_work_from_histogram(hist: np.ndarray, n_shards: int) -> np.ndarray:
    """Fold a partition histogram onto shards (partition p -> shard
    p % n_shards, the static assignment of SURVEY.md §2.4 P8)."""
    h = np.asarray(hist, dtype=np.float64)
    pad = (-h.size) % n_shards
    h = np.pad(h, (0, pad))
    return h.reshape(-1, n_shards).sum(axis=0)


# ---------------------------------------------------------------------------
# Full traces
# ---------------------------------------------------------------------------

#: The port's spans, each a stretch of one join's host work.  They nest:
#: a stretch belongs to the innermost span that covers it.
SPANS = {
    "hj.join": "a join step, its line included (the outermost call of a "
               "joins.DISPATCH entry; the multijoin's "
               "wisconsin.driver.join_tables)",
    "hj.sniff": "issuing a sniff's device chain",
    "hj.plan": "the planner's host work: route, guess, dial, what to do "
               "after a readback; around an engine call "
               "(joins.common.engine_join, the dial's replan) also the "
               "engine's host work between its own spans; the multipass "
               "radix join's tile and digit width "
               "(joins.radix._multipass_radix_join); the multijoin's "
               "factories and the joiner's init "
               "(wisconsin.driver.join_tables)",
    "hj.enqueue": "issuing the join's device chain",
    "hj.readback": "a host wait on the device, and its copy "
                   "(timing.readback, timing.fence_outputs)",
    "hj.retry": "the exact bitonic retry after an abort",
    "hj.repair": "the batched recount of flagged tiles",
    "hj.recount": "the mass path's recount of a sorted plan's flagged "
                  "tiles in place (a one-key tile from its band's ends, "
                  "K4 over the others' whole bands)",
    "hj.split": "a multijoin partition split of one side and its fence "
                "(wisconsin.driver.join_tables: the partitioner's split, "
                "K7 on the card at reference scale)",
    "hj.partition": "the multipass radix join's partition passes "
                    "(ops.radix_kernels.multipass_radix_partition: K2 "
                    "and K6 a pass) and their fence",
    "hj.passplan": "a multipass partition's small planning ops, whose "
                   "issue the card waits for: each pass's digit bounds "
                   "and scatter plan between its K2 and K6, and the next "
                   "pass's tile parents after an intermediate K6",
    "hj.schedule": "a multijoin probe's host work that the card waits "
                   "for (wisconsin.joiners.HashJoiner): the schedule, "
                   "the checks, uploads and allocations before the first "
                   "block, the measured schedule after the heads' "
                   "readback, and the per-partition costs",
    "hj.build": "a scatter build (joins.common.scatter_join, "
                "ops/insert.py): its device chain and fence, then the "
                "spill's readback and any compaction and sort "
                "(joins.common.SpillState); a multijoin's build "
                "(the joiner's build and its fence); the multipass radix "
                "join's build (the final tile sort, the key sums and "
                "their fence)",
    "hj.probe": "a scatter build's probe: the table probe and its fence, "
                "the spill's probe, and their readbacks; a multijoin's "
                "probe (the joiner's probe, the output's materialisation "
                "and its fence); the multipass radix join's probe (K3 "
                "on an unsorted S, the banded count, its readback and "
                "any repair)",
    "hj.line": "building the join's line, and its dict in the reference "
               "schema (JoinMetrics.to_dict, which its caller calls); a "
               "multijoin's line, the output's sums and their readback; "
               "the multipass radix join's key sums' readback",
}

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A record function named ``name`` while a torch profiler records,
    else a shared no-op context: with no profiler, a span reads one flag
    and allocates nothing.  It records with torch's C++ form,
    ``_RecordFunctionFast``, where torch has one: a ``cpu_op`` event in
    the trace, at about a tenth of the cost of the Python class, whose
    event is a ``user_annotation``."""
    if _autograd_profiler._is_profiler_enabled:
        return _record_function(name)
    return _NO_SPAN


def _record_function(name: str):
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return fast(name) if fast else torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block: host activity and, with a card
    present, its kernels; a Chrome trace (``*.pt.trace.json``) lands in
    ``logdir`` when the block ends (view with TensorBoard or Perfetto)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
