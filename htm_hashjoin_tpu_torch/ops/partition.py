"""Radix partitioning: histogram, exclusive scan and the MSB partition of a
sorted relation (counterpart of ``htm_hashjoin_tpu/ops/partition.py``).

The reference's per-thread histogram, barrier, cross-thread prefix sum and
scatter (mc/src/parallel_radix_join.c:559-627) collapse, under MSB digits,
into one key sort: ascending key order is partition-contiguous order with
keys ascending within every partition, and the histogram falls out of the
sorted keys by binary search at the digit boundaries.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PartitionResult(NamedTuple):
    keys: torch.Tensor      # input reordered so partitions are contiguous
    digits: torch.Tensor    # digit of each reordered key
    hist: torch.Tensor      # (fanout,) int32 partition sizes
    offsets: torch.Tensor   # (fanout,) int32 exclusive prefix sums


def histogram(digits: torch.Tensor, fanout: int) -> torch.Tensor:
    """Partition-size histogram (parallel_radix_join.c:571-585 analog)."""
    return torch.bincount(digits.to(torch.int64),
                          minlength=fanout)[:fanout].to(torch.int32)


def exclusive_scan(hist: torch.Tensor) -> torch.Tensor:
    """Output offsets (parallel_radix_join.c:588-598 prefix sum analog)."""
    return (torch.cumsum(hist, 0) - hist).to(hist.dtype)


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bit length of a non-negative int32 scalar tensor, on its device
    (exact: no float log2 rounding at powers of two)."""
    x = x.to(torch.int32)
    bl = torch.zeros((), dtype=torch.int32, device=x.device)
    for s in (16, 8, 4, 2, 1):
        hi = x >> s
        take = hi > 0
        bl = bl + torch.where(take, s, 0)
        x = torch.where(take, hi, x)
    return bl + (x > 0).to(torch.int32)


def radix_partition_msb(keys: torch.Tensor, bits: int, *,
                        sorter=lambda k: torch.sort(k).values):
    """MSB radix partition via a plain key sort (the Wisconsin
    partitioner's MSB convention, mc/wisconsin-src/partitioner.cpp:443-520):
    digits are the key's top ``bits`` below its bit length, shift =
    bit_length(max key) - bits, found on the device.

    Returns (PartitionResult, shift) with shift a device scalar."""
    fanout = 1 << bits
    n = keys.numel()
    out_keys = sorter(keys)
    top = out_keys[-1:].amax() if n else torch.zeros(
        (), dtype=torch.int32, device=keys.device)
    shift = torch.clamp(bit_length(top) - bits, min=0)
    digits = ((out_keys >> shift) & (fanout - 1)).to(torch.int32)
    # sorted keys: the histogram is searchsorted diffs at the digit
    # boundaries; the last boundary fanout << shift can pass int32, so it
    # is replaced by n
    bounds = (torch.arange(1, fanout, dtype=torch.int64,
                           device=keys.device) << shift).to(torch.int32)
    cum = torch.searchsorted(out_keys, bounds, side="left").to(torch.int32)
    zero = torch.zeros(1, dtype=torch.int32, device=keys.device)
    hist = torch.diff(torch.cat([zero, cum, zero + n]))
    return PartitionResult(out_keys, digits, hist, exclusive_scan(hist)), shift
