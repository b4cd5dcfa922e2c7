"""Probe-phase primitives of the sort route (counterpart of
``htm_hashjoin_tpu/ops/probe.py``): multiset match counts from one sorted
stream of tagged keys.  These are the torch glue around the kernels, not
kernels themselves (the JAX package leaves them to XLA)."""

from __future__ import annotations

import torch


def segmented_count_tagged(comp_sorted: torch.Tensor) -> torch.Tensor:
    """Multiset match count (int64 scalar) from a SORTED ``key*2+tag``
    composite stream (tag 0 build, 1 probe): per probe element 2k+1, the
    number of build elements 2k, which sort just before it.

    The JAX package takes the same count from a cumsum and a segment-start
    cummax; torch's cummax (it also returns indices) took 98 ms for 2^25
    keys on an H100, two binary searches of the sorted stream take a few.
    Any integer dtype; an odd entry that is padding (MAXI32 in an int32
    stream) has no build element 2k below it unless the build side holds
    its key."""
    first = torch.searchsorted(comp_sorted, comp_sorted, side="left")
    build_first = torch.searchsorted(comp_sorted, comp_sorted - 1,
                                     side="left")
    return torch.sum(torch.where((comp_sorted & 1) == 1, first - build_first,
                                 0), dtype=torch.int64)


def probe_sorted(build_keys: torch.Tensor, skeys: torch.Tensor) -> torch.Tensor:
    """Equi-join match count (int64 scalar), multiset-correct (duplicates on
    both sides multiply), of any int32 keys: one sort of the int64 composite
    ``key*2+tag`` of both sides, then ``segmented_count_tagged``.  Neither
    input needs to be sorted.  int64 because this route carries keys up to
    2^31 - 1 (the random distribution, which is what sends the radix join
    here)."""
    comp = torch.cat([build_keys.to(torch.int64) * 2,
                      skeys.to(torch.int64) * 2 + 1])
    return segmented_count_tagged(torch.sort(comp).values)
