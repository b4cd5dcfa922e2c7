"""Conflict-free hash-table construction (counterpart of
``htm_hashjoin_tpu/ops/insert.py``), in the JAX package's round formulation.

These replace every concurrency-control mechanism of the reference with
data-parallel rounds:

  * ``nocc_build``: the unsynchronised NoCC build (NoCCHashBuild.hpp:43-63):
    every pending tuple whose slot looked empty writes it, concurrent
    writers race and all of them believe they placed, so colliding tuples
    are lost (outputSum < inputSum);
  * ``claim_insert_round``: one CAS round (AtomicHashBuild.hpp:43-64): the
    attempters of a slot are arbitrated through a claim table of row
    indices;
  * ``open_addressing_build``: ``probe_length`` claim rounds over a flat
    table (the Atomic build);
  * ``bucket_build``: an S-slot bucket table filled one intra-slot a round
    (HTM's 3-slot buckets, HTMHashBuild.hpp:41-45; NPO's 2-tuple buckets,
    mc/src/npj_types.h:31-37);
  * ``htm_optimistic_build``: one optimistic scatter at bucket*3 + key%3
    (the transaction), gather-back failure detection (the abort), claim
    rounds into the bucket's free slots (TM_RETRY, HTMHashBuild.hpp:219-278).

Every build returns the residual ``pending`` mask, the tuples that did not
land; ``spill_sorted`` makes them the probe-able conflicts array
(HTMHashBuild.hpp:79-83).

Left out on purpose, since no join calls them: the JAX package's
claim-free rounds for distinct keys (``_fast_insert_round`` and the
``unique_keys`` flags; here they would run the same claim and write and
add a gather, and on distinct keys the claim's winner is the key found
there), ``nocc_scatter`` (``nocc_build`` with ``probe_length`` 1), and
``bucket_build``'s ``table`` and ``pending`` arguments (``htm_optimistic_build``
runs its retry rounds on its own table).

**The winner of a slot is the highest row index**, by construction.  Several
tuples may write one slot in one round (a claim round, nocc's racy write,
npo's buckets taking keys k and k + num_buckets, the optimistic scatter on
a bucket wrap).  The JAX package's CPU scatter keeps the last (highest)
row; its TPU leaves the order unspecified; torch's ``index_put_`` keeps an
arbitrary one, on the CPU as on the card.  So every such write here is two
steps (``_scatter_highest``): the claim table takes the largest row index
a slot sees (``scatter_reduce_`` with ``amax``, an ``atomicMax`` on the
card), then only that row writes the slot (``index_put_`` never sees two
writes to one index).  The table layout, the pending and failed masks and
the per-chunk failure fractions are therefore the same on the CPU, on the
card and in the JAX package's CPU run, for every distribution, nocc's
included: nocc keeps its lost-update semantics (every attempter leaves
``pending``) with a fixed winner.

``mode="drop"`` has no torch counterpart: the table and the claim table
carry one spare slot per row past ``table_size`` (n slots for n keys),
which takes that row's write when it is idle or loses its slot, and the
builds cut them off before anything sums or probes the table.  One spare
slot shared by all rows would do on the CPU, but after the first round on
unique keys nearly every row is idle, and their atomicMax on one address
serialise on the card (a region of 1024 spare slots still made the idle
rounds cost more than all the rest of the build).  Row indices are int32
(the claim table's entries), slots int64.

**On CUDA tensors the claim rounds run a kernel** (``csrc/claim_insert.cu``,
one launch a round): ``open_addressing_build``'s, ``bucket_build``'s and
the retry rounds of ``htm_optimistic_build``, each through the slot rule
its call fixes ((h + j) & mask, or h * S + j in S-slot buckets).  The
torch formulation above is the kernel's plain version and runs on CPU
tensors (``open_addressing_build_ref`` runs it on any device); the table
and ``pending`` are equal bit for bit, with no spare slot and no R-sized
int64 vector on the card.  nocc's rounds (every attempter leaves
``pending``) and htm's optimistic scatter keep ``_scatter_highest`` on
every device: their semantics differ.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import _args, _build
from .hashing import identity_hash, locality_hash

EMPTY = 0   # keys are >= 1 (generators emit 1..N); 0 marks an empty slot
KEY_DTYPE = torch.int32
CLAIM_ROWS = 0   # rows handed to the claim step, idle rows included (the
                 # line's claimRows, joins.common.join_scope)
LAUNCHES = 0   # builds whose claim rounds ran the kernel (the plain path
               # adds none)
# hashes the kernel computes itself (its hash kind); it is handed any other
# hash's values as int32
_KERNEL_HASHES = {identity_hash: 1, locality_hash: 2}

HashFn = Callable[[torch.Tensor, int], torch.Tensor]


def _rows(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _table(size: int, n: int, device) -> torch.Tensor:
    """An empty table of ``size`` slots plus the spare ones of n rows."""
    return torch.zeros(size + n, dtype=KEY_DTYPE, device=device)


def _claims(size: int, n: int, device) -> torch.Tensor:
    return torch.full((size + n,), -1, dtype=torch.int32, device=device)


def _scatter_highest(table: torch.Tensor, claim: torch.Tensor,
                     slot: torch.Tensor, active: Optional[torch.Tensor],
                     keys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[slot[i]] = keys[i]`` for the ``active`` rows (all if None),
    where the highest row i of a slot wins: the claim table takes each
    targeted slot's largest row index (earlier claims of the slot do not
    count), then only that row writes the slot and every other row writes
    its own spare slot, so no two writes share an index.  Idle rows
    target their spare slot.  Counts every row in ``CLAIM_ROWS``.
    Returns the winning row of each row's target (int32)."""
    global CLAIM_ROWS
    CLAIM_ROWS += keys.numel()
    spare = idx.to(torch.int64).add_(table.numel() - keys.numel())
    tgt = slot if active is None else torch.where(active, slot, spare)
    claim.scatter_reduce_(0, tgt, idx, "amax", include_self=False)
    win = claim[tgt]
    table.index_put_((torch.where(win == idx, tgt, spare),), keys)
    return win


def nocc_build(keys: torch.Tensor, table_size: int, probe_length: int,
               hash_fn: HashFn) -> Tuple[torch.Tensor, torch.Tensor]:
    """The NoCC build (NoCCHashBuild.hpp:43-63): unsynchronised linear
    probing with a probe budget.  Round j: every pending tuple whose slot
    (h+j) & mask looked empty writes it; the highest row of a slot wins and
    the others are lost, and winners and losers alike leave ``pending``.
    Tuples that exhaust the budget stay pending (the conflicts set, whose
    key sum the caller adds to outputSum).  Returns (table, pending)."""
    n, dev, mask = keys.numel(), keys.device, table_size - 1
    h = hash_fn(keys, mask).to(torch.int64)
    table, claim = _table(table_size, n, dev), _claims(table_size, n, dev)
    idx = _rows(n, dev)
    pending = torch.ones(n, dtype=torch.bool, device=dev)
    for j in range(min(probe_length, table_size)):
        slot = torch.add(h, j).bitwise_and_(mask)
        attempt = pending & (table[slot] == EMPTY)          # racy read
        _scatter_highest(table, claim, slot, attempt, keys, idx)
        pending = pending & ~attempt                        # all "placed"
    return table[:table_size], pending


def claim_insert_round(table: torch.Tensor, claim: torch.Tensor,
                       keys: torch.Tensor, slot: torch.Tensor,
                       pending: torch.Tensor, idx: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One atomic-CAS round: every pending key attempts its ``slot`` if
    that slot is empty; the claim table arbitrates, the highest row index
    winning.  ``table`` and ``claim`` hold table_size + n slots (the n
    spare ones last, n = keys.numel()) and are updated in place.  Returns
    (table, claim, new_pending)."""
    attempt = pending & (table[slot] == EMPTY)
    win = _scatter_highest(table, claim, slot, attempt, keys, idx)
    return table, claim, pending & ~(attempt & (win == idx))


def _insert_rounds(table, claim, keys, slots, pending):
    """Claim rounds over the int64 slot vectors ``slots`` (an iterable);
    ``table`` and ``claim`` carry the spare slots."""
    idx = _rows(keys.numel(), keys.device)
    for slot in slots:
        table, claim, pending = claim_insert_round(table, claim, keys, slot,
                                                   pending, idx)
    return table, pending


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def _kernel_rounds(fn: str, keys: torch.Tensor, hash_fn: HashFn, mask: int,
                   stride: int, rounds: int, size: int,
                   pending: Optional[torch.Tensor] = None,
                   seed: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The claim rounds on the card (``csrc/claim_insert.cu``): ``rounds``
    rounds of the slot rule (h + j) & mask (``stride`` 0) or h * stride + j
    into a table of ``size`` slots, h = ``hash_fn(keys, mask)`` in
    [0, mask], for the rows of ``pending`` (all if None), around the keys
    of ``seed`` (``size`` slots, 0 empty) if given.  Counts n rows a round
    in ``CLAIM_ROWS``.  Returns (table, pending)."""
    global LAUNCHES, CLAIM_ROWS
    dev = _args.int32_vectors(fn, keys=keys)
    n = keys.numel()
    if size > 1 << 31 or n >= 1 << 31:
        raise ValueError(f"{fn}: the kernel takes at most 2^31 slots and "
                         f"2^31 - 1 keys, got {size} and {n}")
    kind = _KERNEL_HASHES.get(hash_fn, 0)
    hvec = (None if kind else
            hash_fn(keys, mask).to(torch.int32).contiguous())
    words = _build.load_library().htm_claim_insert_scratch_words(n, size,
                                                                 kind)
    scratch = torch.empty(words, dtype=torch.int64, device=dev)
    table = torch.empty(size, dtype=KEY_DTYPE, device=dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    _args.launch(fn, "htm_claim_insert", dev, keys.data_ptr(), _ptr(hvec),
                 kind, n, mask, stride, rounds, _ptr(pending), _ptr(seed),
                 size, scratch.data_ptr(), words, table.data_ptr(),
                 out.data_ptr())
    LAUNCHES += 1
    CLAIM_ROWS += n * rounds
    return table, out


def open_addressing_build(keys: torch.Tensor, table_size: int,
                          probe_length: int, hash_fn: HashFn
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear probing with a probe budget (AtomicHashBuild.hpp:37-67):
    round j tries slot (h+j) & mask.  After ``probe_length`` rounds (at
    most table_size: more would rescan slots) the residual ``pending`` is
    the conflicts set.  Returns (table, pending): the kernel's on CUDA
    tensors, the plain version's (``open_addressing_build_ref``) on CPU
    tensors."""
    if _args.runs_kernel("open_addressing_build", keys.device):
        return _kernel_rounds("open_addressing_build", keys, hash_fn,
                              table_size - 1, 0,
                              min(probe_length, table_size), table_size)
    return open_addressing_build_ref(keys, table_size, probe_length, hash_fn)


def open_addressing_build_ref(keys: torch.Tensor, table_size: int,
                              probe_length: int, hash_fn: HashFn
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of ``open_addressing_build`` (any device): the
    claim rounds over a table and a claim table with the spare slots."""
    n, dev, mask = keys.numel(), keys.device, table_size - 1
    h = hash_fn(keys, mask).to(torch.int64)
    table, pending = _insert_rounds(
        _table(table_size, n, dev), _claims(table_size, n, dev), keys,
        (torch.add(h, j).bitwise_and_(mask)
         for j in range(min(probe_length, table_size))),
        torch.ones(n, dtype=torch.bool, device=dev))
    return table[:table_size], pending


def _bucket_slots(keys, num_buckets, slots, hash_fn):
    """Round r's slots of an S-slot bucket table: intra-slot r of each
    key's bucket."""
    base = hash_fn(keys, num_buckets - 1).to(torch.int64) * slots
    return (base + r for r in range(slots))


def bucket_build(keys: torch.Tensor, num_buckets: int, slots: int,
                 hash_fn: HashFn) -> Tuple[torch.Tensor, torch.Tensor]:
    """S-slot bucketed build, round r filling intra-slot r of each bucket:
    HTM's Bucket{tuples[3]} (HTMHashBuild.hpp:41-45) with S=3, NPO's
    2-tuple buckets (mc/src/npj_types.h:31-37) with S=2.  Overflow
    (``pending`` after S rounds) is the overflow-chain analog.  Returns
    (table, pending), the kernel's on CUDA tensors."""
    size, n, dev = num_buckets * slots, keys.numel(), keys.device
    if _args.runs_kernel("bucket_build", dev):
        return _kernel_rounds("bucket_build", keys, hash_fn, num_buckets - 1,
                              slots, slots, size)
    table, pending = _insert_rounds(
        _table(size, n, dev), _claims(size, n, dev), keys,
        _bucket_slots(keys, num_buckets, slots, hash_fn),
        torch.ones(n, dtype=torch.bool, device=dev))
    return table[:size], pending


class OptimisticBuildResult(NamedTuple):
    table: torch.Tensor              # (num_buckets * 3,) int32
    pending: torch.Tensor            # (n,) bool: spilled tuples (conflicts)
    failed_optimistic: torch.Tensor  # (n,) bool: the aborted transactions


def htm_optimistic_build(keys: torch.Tensor, num_buckets: int, *,
                         retry: bool = True) -> OptimisticBuildResult:
    """The HTM build (HTMHashBuild.hpp:157-278) as the JAX package runs it.

    Phase 1 (the transaction): scatter every key at bucket*3 + key%3, where
    bucket = (key // 3) & mask: injective for dense unique keys when
    3 * num_buckets > max(key).  Phase 2 (the abort): a row that did not
    win its slot lost a collision (duplicates or a bucket wrap);
    ``failed_optimistic`` is the failedTransactions statistic
    (HTMHashBuild.hpp:188-191).  Phase 3 (TM_RETRY,
    HTMHashBuild.hpp:219-278): claim rounds place failures into free slots
    of their bucket; the residue spills (the kernel's rounds on CUDA
    tensors, around phase 1's table)."""
    n, size = keys.numel(), num_buckets * 3
    dev = keys.device
    slot = (locality_hash(keys, num_buckets - 1).to(torch.int64) * 3
            + keys % 3)
    table, claim, idx = (_table(size, n, dev), _claims(size, n, dev),
                         _rows(n, dev))
    failed = _scatter_highest(table, claim, slot, None, keys, idx) != idx
    if not retry:
        return OptimisticBuildResult(table[:size], failed, failed)
    if _args.runs_kernel("htm_optimistic_build", dev):
        table, pending = _kernel_rounds(
            "htm_optimistic_build", keys, locality_hash, num_buckets - 1, 3,
            3, size, pending=failed, seed=table[:size])
        return OptimisticBuildResult(table, pending, failed)
    table, pending = _insert_rounds(
        table, claim, keys,
        _bucket_slots(keys, num_buckets, 3, locality_hash), failed)
    return OptimisticBuildResult(table[:size], pending, failed)


def spill_sorted(keys: torch.Tensor,
                 pending: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The spilled tuples, compacted and sorted: the conflicts-array analog
    (HTMHashBuild.hpp:79-83), made searchable for the probe phase.  Returns
    (sorted spill, conflict count).

    The JAX function keeps the whole R-sized array with INT32_MAX in the
    unspilled places, so its probe counts an S key equal to INT32_MAX once
    per unspilled tuple, and it sorts R-sized arrays for a few spilled
    keys; compacting first avoids both (ROADMAP queue 3, reference fault
    8).  The compaction reads the count back."""
    spill = keys[pending]
    return torch.sort(spill).values, spill.numel()


def chunk_failure_fractions(failed: torch.Tensor, chunk: int) -> torch.Tensor:
    """Per-chunk failure fractions (float32, the last chunk zero-padded):
    the per-16384-tuple abort rate that drives HTM_ADAPT
    (HTMHashBuild.hpp:196-211).  The count is exact and scaled by the
    float32 reciprocal of ``chunk``: XLA turns the JAX package's float32
    mean (a division by a constant) into that product, which rounds
    differently from a division unless ``chunk`` is a power of two."""
    n = failed.numel()
    counts = torch.nn.functional.pad(failed.to(torch.int32),
                                     (0, (-n) % chunk)).view(-1, chunk).sum(1)
    inv = torch.tensor(1.0, dtype=torch.float32) / chunk
    return counts.to(torch.float32) * inv.to(failed.device)
