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
from typing import Optional

import torch

from ..config import JoinConfig
from ..ops import insert, probe
from ..ops.hashing import identity_hash
from ..relation import Relation, next_pow2
from ..utils.metrics import JoinMetrics
from .common import engine_join, join_scope, scatter_join, use_pallas_engine

BUCKET_SIZE = 2  # npj_params.h:18-20


def _probe(table: torch.Tensor, skeys: torch.Tensor) -> torch.Tensor:
    return probe.probe_buckets(table, skeys, BUCKET_SIZE, identity_hash)


def _overflows(m: JoinMetrics) -> None:
    """totalOverflows: the engine's flagged tiles, or the spill's size."""
    m.totalOverflows = m.conflictCount


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
        return engine_join("npo", r, s, cfg, fields=_overflows,
                           sustained=False)

    def build(keys: torch.Tensor):
        return insert.bucket_build(
            keys, next_pow2(max(2, cfg.r_size // BUCKET_SIZE)), BUCKET_SIZE,
            identity_hash)

    return scatter_join("npo", r, s, cfg, build, _probe, fields=_overflows)
