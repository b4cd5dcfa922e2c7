"""``multijoin``'s plain reference: the numbers of a multijoin's line
worked out again from the two tables the benchmark made for a join
(``inputs.r_keys``, ``inputs.r_rows``, ``inputs.s_keys``,
``inputs.s_rows``), for a conf whose output row is (R's row id, S's row
id) for every pair of an R row and an S row with equal keys.  It imports
nothing of the program.

R is sorted by key, and each S key's R rows are the run two binary
searches find in it; where R's keys repeat, every match counts.  Each
number is exact in 64 bits, the sums wrapping there as the program's do:
``outputRows``, the matches; ``outputBuildSum`` and ``outputProbeSum``,
the sums of the output's R and S row ids; ``outputPairSum``, the sum of
their products.

What the check cannot see: on ``fk_uniform`` R is a permutation of
1..|R| and S holds each R key |S| / |R| times, so ``outputRows``,
``outputBuildSum`` and ``outputProbeSum`` are fixed by the sizes on every
seed.  Only ``outputPairSum`` depends on the data: a join that pairs the
wrong rows but keeps the counts shows in it alone.
"""

from __future__ import annotations

import torch

FIELDS = ("outputRows", "outputBuildSum", "outputProbeSum", "outputPairSum")
BLOCK = 1 << 24     # S rows a block: its int64 temporaries stay small


def expected(inputs, accumulator=torch.int64) -> dict:
    """The numbers the join's line is held to; with ``torch.int32``, the
    control."""
    acc = accumulator
    order = torch.argsort(inputs.r_keys, stable=True)
    r_keys = inputs.r_keys[order]
    prefix = torch.cat([torch.zeros(1, dtype=acc, device=r_keys.device),
                        torch.cumsum(inputs.r_rows[order].to(acc), 0,
                                     dtype=acc)])
    totals = torch.zeros(len(FIELDS), dtype=acc, device=r_keys.device)
    s_keys, s_rows = inputs.s_keys, inputs.s_rows
    for a in range(0, s_keys.numel(), BLOCK):
        keys = s_keys[a:a + BLOCK]
        rows = s_rows[a:a + BLOCK].to(acc)
        lo = torch.searchsorted(r_keys, keys)
        hi = torch.searchsorted(r_keys, keys, right=True)
        count = (hi - lo).to(acc)
        build = prefix[hi] - prefix[lo]     # the matched R row ids' sum
        totals += torch.stack([count.sum(dtype=acc), build.sum(dtype=acc),
                               (count * rows).sum(dtype=acc),
                               (build * rows).sum(dtype=acc)])
    return dict(zip(FIELDS, totals.tolist()))
