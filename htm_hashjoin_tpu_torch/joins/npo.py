"""NPO: the no-partitioning join over a shared chained-bucket table.

Counterpart of ``htm_hashjoin_tpu/joins/npo.py`` (reference
mc/src/no_partitioning_join.c:174-612: a global table of 2-tuple buckets,
npj_types.h:31-37, BUCKET_SIZE=2, nbuckets = |R|/2 rounded to a power of
two; latched inserts with overflow chains, build_hashtable_mt :383-439; a
latch-free chain-walking probe, :270-310).

Where the banded engine qualifies, the table is the engine's: the bucket
chains are sorted runs and the chain walk is the banded merge count (the
same matches and conservation); ``totalOverflows`` is its flagged tiles.
Otherwise a 2-slot ``bucket_build`` (claim rounds arbitrate, no latches)
builds it, the overflow chains become the sorted spill, which the probe
searches, and ``totalOverflows`` is the spill's size.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..config import JoinConfig
from ..ops import insert, probe
from ..ops.hashing import identity_hash
from ..relation import Relation, next_pow2
from ..utils.metrics import JoinMetrics
from ..utils.profiler import span
from ..utils.timing import PhaseTimer, readback
from .banded_backend import banded_join_pipelined
from .common import (SpillState, finish_metrics, join_scope, keys_unique_both,
                     pallas_metrics, pallas_plan, resolve_relations,
                     use_pallas_engine)

BUCKET_SIZE = 2  # npj_params.h:18-20


def _build(keys: torch.Tensor, num_buckets: int):
    table, pending = insert.bucket_build(keys, num_buckets, BUCKET_SIZE,
                                         identity_hash)
    return (table, pending, probe.table_sum(table),
            torch.sum(keys, dtype=torch.int64))


@join_scope
def npo_st_join(r: Relation, s: Optional[Relation] = None,
                cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    """NPO_st, the reference's single-threaded NPO (mc/src/
    no_partitioning_join.c:336-373): the same table layout and probe,
    always as the bucket build (``backend="xla"``, no mesh)."""
    m = npo_join(r, s, dataclasses.replace(cfg, backend="xla",
                                           mesh_shape=()))
    m.algo = "npo_st"
    return m


@join_scope
def npo_join(r: Relation, s: Optional[Relation] = None,
             cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    if use_pallas_engine(cfg, s):
        plan = pallas_plan(cfg)
        t0 = time.perf_counter()
        out = banded_join_pipelined(r.keys, s.keys,
                                    locality_window=plan.window,
                                    presort=plan.presort,
                                    presorted=plan.presorted,
                                    narrow=plan.narrow,
                                    sort_s=not s.assume_sorted,
                                    unique_both=keys_unique_both(cfg))
        elapsed_us = (time.perf_counter() - t0) * 1e6
        m = pallas_metrics(cfg, "npo", out, elapsed_us, out.matches,
                           plan=plan, sort_s=not s.assume_sorted)
        m.totalOverflows = out.overflow_tiles
        return m
    rkeys, skeys = resolve_relations(r, s, cfg)
    timer = PhaseTimer()
    with span("hj.build"):
        table, pending, table_sum, in_sum = timer.timed(
            "build", _build, rkeys,
            next_pow2(max(2, cfg.r_size // BUCKET_SIZE)))
        spill = SpillState(rkeys, pending, timer, head=(table_sum, in_sum))
    table_sum, in_sum = spill.head
    matches = None
    if skeys is not None:
        with span("hj.probe"):
            matches = readback(timer.timed(
                "probe", probe.probe_buckets, table, skeys, BUCKET_SIZE,
                identity_hash))
            matches += spill.probe_count(skeys, timer)
    m = JoinMetrics(algo="npo", rSize=cfg.r_size,
                    transactionSize=cfg.transaction_size,
                    probeLength=cfg.probe_length, conflictCount=spill.count,
                    totalOverflows=spill.count, inputSum=in_sum,
                    outputSum=table_sum + spill.key_sum)
    return finish_metrics(m, timer, matches)
