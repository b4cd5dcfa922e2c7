"""Sort-merge primitives (counterpart of ``htm_hashjoin_tpu/ops/sortops.py``).

The reference sort-merge (SortMerge.cpp:8-70) sorts with a partitioned
timsort and merges with a two-pointer count.  Here the sort is K3 (or its
plain version) and the merge count is two binary searches a probe key into
the sorted build side: multiset-correct, the two-pointer count's answer
(SortMerge.cpp:22-36).  The JAX package re-sorts both sides as tagged
composites (``probe.probe_sorted``); the sides are sorted already, so the
port does not."""

from __future__ import annotations

import torch


def merge_count(sorted_build: torch.Tensor,
                probe_keys: torch.Tensor) -> torch.Tensor:
    """Equi-join matches (int64 device scalar) of ``probe_keys`` against
    the ascending ``sorted_build``, duplicates multiplying (SortMerge.cpp:
    22-36 semantics).  The probe side need not be sorted; sorted, its
    searches walk the build side in order."""
    hi = torch.searchsorted(sorted_build, probe_keys, right=True,
                            out_int32=True)
    lo = torch.searchsorted(sorted_build, probe_keys, out_int32=True)
    return torch.sum(hi - lo, dtype=torch.int64)
