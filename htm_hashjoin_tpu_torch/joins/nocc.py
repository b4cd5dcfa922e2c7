"""NoCC join: the unsynchronised build, whose races lose tuples.

Counterpart of ``htm_hashjoin_tpu/joins/nocc.py`` (reference
NoCCHashBuild.hpp:13-151): the upper-bound-throughput baseline, whose
races silently lose tuples (outputSum < inputSum,
experiments/new_backup/AtomicsVsHTMVsNoCC_log1:1).  It linear-probes with
a probeLength budget and spills the tuples that exhaust it to a conflicts
set counted into outputSum (NoCCHashBuild.hpp:43-63, 103-146); the race
is each round's unsynchronised read-then-write (``insert.nocc_build``),
whose winner is the highest row, so the loss is the same on every device.

The probe scans the table only (NoCCHashBuild.hpp:65-80): the conflicts
feed outputSum, never totalMatches, so the losses stay visible.  On
generator-certified unique keys nothing is lost and the banded engine runs
instead (``common.pallas_unique_join``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import JoinConfig
from ..ops import insert, probe
from ..ops.hashing import identity_hash
from ..relation import Relation
from ..utils.metrics import JoinMetrics
from ..utils.profiler import span
from ..utils.timing import PhaseTimer, readback
from .common import (SpillState, finish_metrics, join_scope,
                     pallas_unique_join, resolve_relations,
                     route_unique_pallas, table_size_for)


def _build(keys: torch.Tensor, table_size: int, probe_length: int):
    table, pending = insert.nocc_build(keys, table_size, probe_length,
                                       identity_hash)
    return (table, pending, probe.table_sum(table),
            torch.sum(keys, dtype=torch.int64))


@join_scope
def nocc_join(r: Relation, s: Optional[Relation] = None,
              cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    if route_unique_pallas(cfg, s):
        return pallas_unique_join("nocc", r, s, cfg)
    rkeys, skeys = resolve_relations(r, s, cfg)
    timer = PhaseTimer()
    with span("hj.build"):
        table, pending, table_sum, in_sum = timer.timed(
            "build", _build, rkeys, table_size_for(cfg), cfg.probe_length)
        spill = SpillState(rkeys, pending, timer, head=(table_sum, in_sum))
    table_sum, in_sum = spill.head
    matches = None
    if skeys is not None:
        # the table only: the spilled conflicts are not probed
        with span("hj.probe"):
            matches = readback(timer.timed(
                "probe", probe.probe_open_addressing, table, skeys,
                cfg.probe_length, identity_hash))
    m = JoinMetrics(algo="nocc", rSize=cfg.r_size,
                    transactionSize=cfg.transaction_size,
                    probeLength=cfg.probe_length, conflictCount=spill.count,
                    inputSum=in_sum, outputSum=table_sum + spill.key_sum)
    return finish_metrics(m, timer, matches)
