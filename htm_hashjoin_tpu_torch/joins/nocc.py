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
instead (``common.engine_join``).
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
def nocc_join(r: Relation, s: Optional[Relation] = None,
              cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    if route_unique_pallas(cfg, s):
        return engine_join("nocc", r, s, cfg,
                           fields=unique_table_fields)

    def build(keys: torch.Tensor):
        return insert.nocc_build(keys, table_size_for(cfg), cfg.probe_length,
                                 identity_hash)

    def probe_table(table: torch.Tensor, skeys: torch.Tensor):
        return probe.probe_open_addressing(table, skeys, cfg.probe_length,
                                           identity_hash)

    # the table only: the spilled conflicts are not probed
    return scatter_join("nocc", r, s, cfg, build, probe_table,
                        probe_spill=False)
