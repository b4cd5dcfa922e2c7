"""The plain reference: the three numbers a join's line is held to,
worked out again from the inputs the benchmark generated.

An equi-join of R and S counts, for every S key, the R tuples with that
key (``totalMatches``), and keeps every R tuple (``inputSum``, the sum of
R's keys, equals ``outputSum``, the sum of the keys the build holds).
Here: one sort of R, two binary searches for each S key, in blocks of S,
with the sums in int64 (the testbed's ``HTMHashBuild.hpp:312-320`` keeps
them in 64 bits).  Plain PyTorch; it imports nothing of the program.

``accumulator=torch.int32`` is the control: the same computation with
32-bit accumulators, the nearest integer precision below the
configuration's.
"""

from __future__ import annotations

import torch

FIELDS = ("totalMatches", "inputSum", "outputSum")
BLOCK = 1 << 26   # S keys a block: bounds the int64 search results


def expected(r_keys: torch.Tensor, s_keys: torch.Tensor,
             accumulator: torch.dtype = torch.int64) -> dict:
    """``{field: value}`` for the join of ``r_keys`` and ``s_keys``."""
    r_sorted = torch.sort(r_keys).values
    matches = torch.zeros((), dtype=accumulator, device=r_keys.device)
    for lo in range(0, s_keys.numel(), BLOCK):
        block = s_keys[lo:lo + BLOCK]
        first = torch.searchsorted(r_sorted, block, side="left")
        last = torch.searchsorted(r_sorted, block, side="right")
        matches += torch.sum(last - first, dtype=accumulator)
    key_sum = int(torch.sum(r_keys, dtype=accumulator))
    return {"totalMatches": int(matches), "inputSum": key_sum,
            "outputSum": key_sum}
