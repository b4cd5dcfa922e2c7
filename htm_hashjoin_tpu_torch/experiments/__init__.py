"""The planner's two experiments on the card (counterparts of the JAX
package's ``experiments/adaptive_dial_bench.py`` and
``experiments/radix_crossover.py``):

    python -m htm_hashjoin_tpu_torch.experiments.adaptive_dial_bench
    python -m htm_hashjoin_tpu_torch.experiments.radix_crossover

Each writes its log to ``RESULTS_DIR`` (not the JAX package's TPU result
directories) and runs on the card unless ``--device`` names another."""

from __future__ import annotations

from typing import Dict

from ..ops import (banded_count, banded_count_narrow, fused_sort_count,
                   global_sort, global_sort_kv, insert, probe, scatter_tiles,
                   sort_kv_tiles, sort_tiles)

RESULTS_DIR = "experiments/results_torch"

# each kernel wrapper by name (K1-K7, K7a, the claim rounds, the table
# probe): its LAUNCHES counts the calls that launched its kernel
_WRAPPERS = {"fused_sort_count": fused_sort_count, "sort_tiles": sort_tiles,
             "global_sort_tiles": global_sort,
             "banded_count": banded_count,
             "banded_count_narrow": banded_count_narrow,
             "scatter_tiles": scatter_tiles, "sort_kv_tiles": sort_kv_tiles,
             "global_sort_kv_tiles": global_sort_kv, "claim_insert": insert,
             "hash_probe": probe}


def kernel_launches() -> Dict[str, int]:
    """Every kernel wrapper's launch count so far, by wrapper name."""
    return {name: mod.LAUNCHES for name, mod in _WRAPPERS.items()}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The kernels launched since ``before`` (a ``kernel_launches()``),
    with their counts; kernels not launched are left out."""
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}
