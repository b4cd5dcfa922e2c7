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
(``common.engine_join``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import JoinConfig
from ..ops import insert, probe
from ..ops.hashing import identity_hash
from ..relation import Relation
from ..utils.metrics import JoinMetrics
from .common import (engine_join, join_scope, route_unique_pallas,
                     scatter_join, table_size_for, unique_table_fields)


@join_scope
def atomic_join(r: Relation, s: Optional[Relation] = None,
                cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    if route_unique_pallas(cfg, s):
        return engine_join("atomic", r, s, cfg,
                           fields=unique_table_fields)

    def build(keys: torch.Tensor):
        return insert.open_addressing_build(
            keys, table_size_for(cfg), cfg.probe_length, identity_hash)

    def probe_table(table: torch.Tensor, skeys: torch.Tensor):
        return probe.probe_open_addressing(table, skeys, cfg.probe_length,
                                           identity_hash)

    return scatter_join("atomic", r, s, cfg, build, probe_table)
