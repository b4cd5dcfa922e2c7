"""Probe-phase primitives (counterpart of ``htm_hashjoin_tpu/ops/probe.py``):
the scatter tables' probe, and multiset match counts from one sorted stream
of tagged keys.  The reference probes are serial loops per probe tuple:
linear scans over open-addressing slots (AtomicHashBuild.hpp:69-86) and
bucket walks (HTMHashBuild.hpp:288-308, mc/src/no_partitioning_join.c:
270-310).

**On CUDA tensors the table probe runs a kernel** (``csrc/hash_probe.cu``,
one launch a probe): every S key's slots read in int32 and counted in one
pass, through the slot rule of the build's claim kernel.  The JAX package
leaves the probe to XLA's gathers; the torch loops of gathers over int64
slot vectors (``probe_open_addressing_ref``, ``probe_buckets_ref``) are the
kernel's plain version and run on CPU tensors, and the count is theirs,
exactly.  The rest of this module is torch glue."""

from __future__ import annotations

from typing import Callable

import torch

from . import _args
from .hashing import kernel_hash

HashFn = Callable[[torch.Tensor, int], torch.Tensor]

LAUNCHES = 0   # probes that ran the kernel (the plain path adds none)


def _kernel_probe(fn: str, table: torch.Tensor, skeys: torch.Tensor,
                  hash_fn: HashFn, mask: int, stride: int,
                  probes: int) -> torch.Tensor:
    """The table probe on the card (``csrc/hash_probe.cu``): the matches
    of each S key among its ``probes`` slots (h + j) & mask (``stride`` 0)
    or h * stride + j, h = ``hash_fn(skeys, mask)`` in [0, mask], as an
    int64 device scalar."""
    global LAUNCHES
    dev = _args.int32_vectors(fn, table=table, skeys=skeys)
    if table.numel() > 1 << 31 or skeys.numel() >= 1 << 31:
        raise ValueError(f"{fn}: the kernel takes at most 2^31 slots and "
                         f"2^31 - 1 keys, got {table.numel()} and "
                         f"{skeys.numel()}")
    kind, hvec = kernel_hash(skeys, hash_fn, mask)
    out = torch.empty((), dtype=torch.int64, device=dev)
    _args.launch(fn, "htm_hash_probe", dev, skeys.data_ptr(),
                 _args.ptr(hvec), kind, skeys.numel(), mask, stride, probes,
                 table.data_ptr(), out.data_ptr())
    LAUNCHES += 1
    return out


def probe_open_addressing(table: torch.Tensor, skeys: torch.Tensor,
                          probe_length: int, hash_fn: HashFn) -> torch.Tensor:
    """Matches (int64 device scalar) of a scan of ``probe_length`` slots
    from h (AtomicHashBuild.hpp:69-86); never more than table_size slots,
    which would revisit one.  The kernel's count on CUDA tensors, the
    plain version's (``probe_open_addressing_ref``) on CPU tensors."""
    if _args.runs_kernel("probe_open_addressing", skeys.device):
        size = table.numel()
        return _kernel_probe("probe_open_addressing", table, skeys, hash_fn,
                             max(size - 1, 0), 0,
                             max(min(probe_length, size), 0))
    return probe_open_addressing_ref(table, skeys, probe_length, hash_fn)


def probe_open_addressing_ref(table: torch.Tensor, skeys: torch.Tensor,
                              probe_length: int,
                              hash_fn: HashFn) -> torch.Tensor:
    """Plain torch version of ``probe_open_addressing`` (any device): one
    gather over an int64 slot vector a slot."""
    table_size = table.numel()
    mask = table_size - 1
    h = hash_fn(skeys, mask).to(torch.int64)
    total = torch.zeros((), dtype=torch.int64, device=skeys.device)
    for j in range(min(probe_length, table_size)):
        total += torch.sum(table[(h + j) & mask] == skeys, dtype=torch.int64)
    return total


def probe_buckets(table: torch.Tensor, skeys: torch.Tensor, slots: int,
                  hash_fn: HashFn) -> torch.Tensor:
    """Matches (int64 device scalar) against an S-slot bucket table
    (HTMHashBuild.hpp:288-308 without the overflow chain: the spilled
    tuples are probed apart, see ``joins/common.SpillState``): the
    kernel's count on CUDA tensors, the plain version's
    (``probe_buckets_ref``) on CPU tensors."""
    if _args.runs_kernel("probe_buckets", skeys.device):
        num_buckets = table.numel() // slots
        if num_buckets < 1:
            raise ValueError(f"probe_buckets: a table of {table.numel()} "
                             f"slots holds no bucket of {slots}")
        return _kernel_probe("probe_buckets", table, skeys, hash_fn,
                             num_buckets - 1, slots, slots)
    return probe_buckets_ref(table, skeys, slots, hash_fn)


def probe_buckets_ref(table: torch.Tensor, skeys: torch.Tensor, slots: int,
                      hash_fn: HashFn) -> torch.Tensor:
    """Plain torch version of ``probe_buckets`` (any device): one gather
    over an int64 slot vector an intra-bucket slot."""
    num_buckets = table.numel() // slots
    base = hash_fn(skeys, num_buckets - 1).to(torch.int64) * slots
    total = torch.zeros((), dtype=torch.int64, device=skeys.device)
    for r in range(slots):
        total += torch.sum(table[base + r] == skeys, dtype=torch.int64)
    return total


def table_sum(table: torch.Tensor) -> torch.Tensor:
    """Sum of the keys in a table (empty slots are 0): half of the
    outputSum conservation oracle (HTMHashBuild.hpp:322-401)."""
    return torch.sum(table, dtype=torch.int64)


def masked_sum(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum of keys[mask] (int64): the conflict accounting."""
    return torch.sum(torch.where(mask, keys, 0), dtype=torch.int64)


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
