"""Atomic join: linear-probing build with a probe budget.

Counterpart of ``htm_hashjoin_tpu/joins/atomic.py`` (reference
AtomicHashBuild.hpp:14-157: an open-addressing table of atomics, inserts by
compare_exchange with budget ``probeLength``, an exhausted budget spilling
to a conflicts array).  Here ``probe_length`` claim rounds
(``insert.open_addressing_build``: a CUDA kernel a round on the card,
``insert.claim_insert_round`` on the CPU) are the CAS steps of all pending
tuples at once; the spill is a sorted, probed array, so no match is lost
(the reference's probe ignored its conflicts).  Conservation holds:
outputSum = the table's sum + the conflicts' (AtomicHashBuild.hpp:90-152).
On generator-certified unique keys the banded engine runs instead
(``common.pallas_unique_join``).
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
    table, pending = insert.open_addressing_build(
        keys, table_size, probe_length, identity_hash)
    return (table, pending, probe.table_sum(table),
            torch.sum(keys, dtype=torch.int64))


@join_scope
def atomic_join(r: Relation, s: Optional[Relation] = None,
                cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    if route_unique_pallas(cfg, s):
        return pallas_unique_join("atomic", r, s, cfg)
    rkeys, skeys = resolve_relations(r, s, cfg)
    timer = PhaseTimer()
    with span("hj.build"):
        table, pending, table_sum, in_sum = timer.timed(
            "build", _build, rkeys, table_size_for(cfg), cfg.probe_length)
        spill = SpillState(rkeys, pending, timer, head=(table_sum, in_sum))
    table_sum, in_sum = spill.head
    matches = None
    if skeys is not None:
        with span("hj.probe"):
            matches = readback(timer.timed(
                "probe", probe.probe_open_addressing, table, skeys,
                cfg.probe_length, identity_hash))
            matches += spill.probe_count(skeys, timer)
    m = JoinMetrics(algo="atomic", rSize=cfg.r_size,
                    transactionSize=cfg.transaction_size,
                    probeLength=cfg.probe_length, conflictCount=spill.count,
                    inputSum=in_sum, outputSum=table_sum + spill.key_sum)
    return finish_metrics(m, timer, matches)
