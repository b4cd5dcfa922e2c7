"""Profiler utilities of the port: so far the barrier-wait breakdown.

Counterpart of ``htm_hashjoin_tpu/utils/profiler.py:sync_stats`` (numpy
only).  The rest of the JAX profiler (trace parsing, counters, cost
analysis) waits for its port.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np


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
