"""Sort-merge join.

Counterpart of ``htm_hashjoin_tpu/joins/sortmerge.py`` (reference
SortMerge.cpp:8-70: a partitioned parallel timsort, a final timsort pass,
then a partitioned two-pointer merge count).  It reports sortTime,
mergeTime and their total like the reference (SortMerge.cpp:50-69).  Two
routes:

  * the engine, where the banded engine qualifies: K3 sorts R (not when R
    is generated sorted), K3 sorts an unsorted probe side
    (``sort_probe_side``), a fence ends the sort phase, then the banded
    count runs on the sorted R (``presorted``: K5, or K4 for duplicate
    keys), ending in its readback;
  * the plain route (``--backend xla``, keys at or above PACK_LIMIT): both
    sides sorted by K3 (its plain version on the CPU), then
    ``sortops.merge_count``.

The JAX package pads R to 65536-key tiles for its global sort, the port to
its 8192-key tile (ROADMAP queue 3); the sorted keys are the same.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..config import Distribution, JoinConfig
from ..ops import sortops
from ..relation import Relation
from ..utils.metrics import JoinMetrics
from ..utils.timing import PhaseTimer, fence_outputs, readback
from .banded_backend import banded_join_pipelined, k3_sort, sort_probe_side
from .common import (BandedPlan, join_scope, keys_unique_both,
                     pallas_metrics, resolve_relations, use_pallas_engine)


def _sort(keys: torch.Tensor):
    s = k3_sort(keys)
    return s, torch.sum(s, dtype=torch.int64)


def _engine_join(r: Relation, s: Relation, cfg: JoinConfig) -> JoinMetrics:
    """Sort-merge as the presorted banded plan, with the sort and the merge
    timed apart (two fences, the reference's two phases)."""
    sorted_in = cfg.data_distr == Distribution.SORTED
    t0 = time.perf_counter()
    # sorted input skips the sort: timsort's O(n) pass on sorted runs
    # (SortMerge.cpp:18)
    r_sorted = r.keys if sorted_in else k3_sort(r.keys)
    if s.assume_sorted:
        skeys_sorted, s2d = s.keys, None
    else:
        skeys_sorted, s2d = sort_probe_side(s.keys)
    fence_outputs((r_sorted, skeys_sorted))        # the sort phase ends
    sort_us = (time.perf_counter() - t0) * 1e6
    t1 = time.perf_counter()
    # its one readback is the second fence
    out = banded_join_pipelined(r_sorted, skeys_sorted, presorted=True,
                                unique_both=keys_unique_both(cfg), s2d=s2d)
    merge_us = (time.perf_counter() - t1) * 1e6
    m = pallas_metrics(cfg, "sortmerge", out, sort_us + merge_us,
                       out.matches,
                       plan=BandedPlan(None, not sorted_in, sorted_in, None),
                       sort_s=not s.assume_sorted)
    m.sortTimeInMicroseconds = sort_us
    m.mergeTimeInMicroseconds = merge_us
    m.probeTimeInMicroseconds = merge_us
    return m


@join_scope
def sortmerge_join(r: Relation, s: Optional[Relation] = None,
                   cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    if use_pallas_engine(cfg, s):
        return _engine_join(r, s, cfg)
    rkeys, skeys = resolve_relations(r, s, cfg)
    timer = PhaseTimer()
    sorted_r, in_sum = timer.timed("sort", _sort, rkeys)
    matches = None
    if skeys is not None:
        # the reference's main.cpp makes S sorted except for the random
        # distribution (main.cpp:89-97); sort unless it is certainly sorted
        if cfg.data_distr != Distribution.SORTED:
            skeys, _ = timer.timed("sort", _sort, skeys)
        matches = readback(timer.timed("merge", sortops.merge_count,
                                       sorted_r, skeys))
    in_sum = readback(in_sum)
    m = JoinMetrics(algo="sortmerge", rSize=cfg.r_size,
                    transactionSize=cfg.transaction_size,
                    inputSum=in_sum, outputSum=in_sum)
    m.sortTimeInMicroseconds = timer.micros.get("sort", 0.0)
    m.mergeTimeInMicroseconds = timer.micros.get("merge", 0.0)
    m.hashBuildTimeInMicroseconds = sum(timer.micros.values())
    if matches is not None:
        m.totalMatches = matches
        m.probeTimeInMicroseconds = m.mergeTimeInMicroseconds
    return m
