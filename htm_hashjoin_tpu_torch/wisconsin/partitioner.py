"""Partitioner family — mc/wisconsin-src/partitioner.cpp:69-757 on tensors.

Counterpart of ``htm_hashjoin_tpu/wisconsin/partitioner.py``.  The
reference's partitioners move tuples between page chains under various
concurrency disciplines:

  * Partitioner           — no-op single split            (:69-114)
  * ParallelPartitioner   — shared output partitions, atomic appends (:117-180)
  * IndependentPartitioner— thread-private partitions, concatenated  (:183-263)
  * DerekPartitioner      — contiguous (non-round-robin) split       (:266-268)
  * RadixPartitioner      — multi-pass MSB radix: per-thread histograms,
                            prefix-sum combine, scatter passes        (:336-520)

Every variant reduces to one conflict-free plan: a sort by partition rank,
the histogram and offsets from binary searches on the sorted ranks.  The
variants are kept because their *outputs* differ — which rows land in
which partition, and in what order — and the joiner policies depend on that:

  * Parallel: partitions ordered by input position (stable by arrival).
  * Independent: partitions ordered by (source shard, position) — each
    shard's contribution is contiguous inside a partition.
  * Radix: the composition of its digit passes is one sort on the full
    bucket id; the final histogram is exposed for FlatMemoryJoiner.

At reference scale on the card (two int32 columns, a ModuloHash, at least
2^22 rows) the split is one key-value global sort of a rotation-packed key
through the hand-written radix sort K7 (``ops/global_sort_kv.py``), as the
JAX package routes it through its Pallas kv sort on the TPU: one kernel
packs the keys (``ops/rot_pack.py``), K7 sorts them with the payload, one
kernel unpacks them (``ops/rot_unpack.py``).  That gate is decided before
any bucket, shard or rank column is made.  Elsewhere — on the CPU, in both
packages — it is a stable sort.

All return a ``PartitionedTable``: the reordered table + per-partition
offset/size arrays (the SplitResult analog, partitioner.h:29).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.global_sort_kv import global_sort_kv_tiles
from ..ops.rot_pack import Shards, rot_pack
from ..ops.rot_unpack import rot_unpack
# the packing's plain versions, under the JAX package's names
from ..ops.rot_pack import rot_pack_ref as _rot_pack
from ..ops.rot_unpack import rot_unpack_ref as _rot_unpack
from ..utils.timing import readback
from .hashfn import HashFunction, ModuloHash, hash_factory
from .table import Table, host, is_strings

KV_TILE = 8192            # the kv split pads to a power-of-two count of these
KV_MIN_ROWS = 1 << 22     # the kv split's row gate (partitioner.py:239)
KV_SPLITS = 0             # splits that ran pack kernel -> K7 -> unpack kernel


@dataclasses.dataclass
class PartitionedTable:
    """SplitResult analog: table rows grouped so partition p occupies rows
    [offsets[p], offsets[p] + sizes[p])."""

    table: Table
    sizes: np.ndarray      # (nparts,) int64
    offsets: np.ndarray    # (nparts,) int64 exclusive prefix sums
    part_hash: Optional[HashFunction] = None  # the hash fn that assigned
                           # rows to partitions (None for no-op/derek
                           # splits).  Lets the joiner certify that build
                           # and probe sides are CO-PARTITIONED (same
                           # fingerprint on the same attribute) and probe
                           # each unit against only its matching build
                           # partition (probe.inl:18-36 locality).
    part_attr: int = 1     # the partitioned attribute (conf 'attribute')
    _perm: object = None   # original row index of each reordered row: a
                           # device tensor from the hash partitioners, a
                           # callable that computes it on first read, or
                           # None = identity (the no-op split), made lazily

    @property
    def perm(self):
        if callable(self._perm):       # deferred recompute (packed reorder)
            self._perm = self._perm()
        if self._perm is None:
            self._perm = np.arange(self.table.num_rows)
        return self._perm

    @property
    def nparts(self) -> int:
        return int(self.sizes.shape[0])

    def partition_rows(self, p: int) -> np.ndarray:
        s, e = int(self.offsets[p]), int(self.offsets[p] + self.sizes[p])
        return np.arange(s, e)


def _reorder_rot2_kv(keys, payload, hashfn: ModuloHash, nparts: int,
                     vmin: int, skip: int, b: int, restbits: int,
                     bias=None, bias_bits: int = 0, tile: int = KV_TILE):
    """Partition split through the key-value global sort (K7): the
    rotation-packed int32 sort key carries (bucket, key); the payload
    column rides the compare-exchanges.  ``bias``: the shard ids, as
    ``rot_pack.rot_pack`` takes them (a ``Shards`` on the card).

    On the card the packing and its inverse are one kernel each around K7
    (``ops/rot_pack.py``, ``ops/rot_unpack.py``), counted in
    ``KV_SPLITS``; on the CPU their plain versions run.

    Layout note: within a partition rows come out KEY-ordered, and rows
    with equal packed keys keep their input order, on the card (K7 is a
    stable radix sort) as on the CPU (a stable torch.sort).  The TPU's
    bitonic network leaves such ties in arbitrary order, as the
    reference's shared-partition appends do (partitioner.cpp:117-180);
    every downstream consumer (scheduled probes, directories, emits) is
    order-insensitive within a partition.  Sizes and offsets do not
    depend on the tile."""
    global KV_SPLITS
    n = keys.shape[0]
    n_tiles = max(1, (n + tile - 1) // tile)
    n_tiles = 1 << (n_tiles - 1).bit_length()
    n_pad = n_tiles * tile
    t, pay = rot_pack(keys, payload, bias, vmin, skip, b, restbits, bias_bits,
                      n_pad)
    ks, vs = global_sort_kv_tiles(t, pay, tile=tile)
    del t, pay
    key_s, pay_s, so = rot_unpack(ks[:n], vs[:n], vmin, skip, b, restbits,
                                  bias_bits, nparts)
    if keys.is_cuda:    # each of the three launched its kernel, or raised
        KV_SPLITS += 1
    return key_s, pay_s, host(so)


def _bounds(rank_s, nparts: int, stride: int) -> torch.Tensor:
    """(2, nparts) int64 [sizes, offsets] of partitions over sorted ranks:
    partition p covers ranks [p·stride, (p+1)·stride)."""
    n = rank_s.shape[0]
    queries = torch.arange(nparts, dtype=rank_s.dtype,
                           device=rank_s.device) * stride
    bounds = torch.searchsorted(rank_s, queries).long()
    ends = torch.cat([bounds[1:], bounds.new_full((1,), n)])
    return torch.stack([ends - bounds, bounds])


def _reorder_device_packed2(cols, rank, nparts: int, stride: int):
    """Two-int32-column path of _reorder_device: both columns ride the
    sort's permutation as ONE packed int64 value (one gather, not two)."""
    a, b = cols
    packed = (a.long() << 32) | (b.long() & 0xFFFFFFFF)
    rank_s, order = torch.sort(rank, stable=True)
    packed_s = packed[order]
    del packed, order
    out_a = (packed_s >> 32).to(torch.int32)
    out_b = packed_s.to(torch.int32)
    return (out_a, out_b), _bounds(rank_s, nparts, stride)


def _reorder_device(cols, rank, nparts: int, stride: int):
    """The partition program: ONE stable sort of the ranks gives both the
    permutation and the sorted ranks; partition offsets fall out of
    binary searches on the sorted ranks."""
    rank_s, perm = torch.sort(rank, stable=True)
    outs = tuple(c[perm] for c in cols)
    return outs, perm, _bounds(rank_s, nparts, stride)


def _on_card(keys: torch.Tensor) -> bool:
    """The kv split's device gate: the keys lie on a CUDA device (the JAX
    package's ``jax.default_backend() == "tpu"``)."""
    return keys.is_cuda


def _kv_split(table: Table, jattr: int, keys, hashfn: ModuloHash,
              shards: Optional[Shards]) -> Optional[PartitionedTable]:
    """The reference-scale split: a rotation-packed int32 sort key through
    the key-value global sort (K7), certified by a fenced read of the key
    range (the bit-field packing must cover the actual keys, and t must
    stay below the MAXI32 padding sentinel); None where it does not."""
    kmin, kmax = readback(torch.stack(torch.aminmax(keys)))
    vmin = hashfn._min
    if kmin < vmin:
        return None
    B = max(1, (kmax - vmin + 1).bit_length())
    b = hashfn._log2k
    skip = hashfn._skipbits
    restbits = max(B - b, skip)
    bias_bits = (0 if shards is None
                 else max(1, (shards.nthreads - 1).bit_length()))
    if b + bias_bits + restbits > 30:
        return None
    payload_idx = 1 if jattr == 1 else 0   # the non-key column (0-based)
    key_s, pay_s, so = _reorder_rot2_kv(
        keys, table.columns[payload_idx], hashfn, hashfn.buckets, vmin, skip,
        b, restbits, bias=shards, bias_bits=bias_bits)
    out_cols = [None, None]
    out_cols[jattr - 1] = key_s
    out_cols[payload_idx] = pay_s
    out = Table(table.schema, out_cols, table.page_size)
    n = keys.shape[0]
    # a CONSISTENT permutation of the same grouping (both sorts are stable,
    # so it matches the kv-sorted layout; the TPU's bitonic network would
    # not), packed again only if read — no consumer pairs perm rows with
    # table rows today
    return PartitionedTable(
        out, so[0], so[1], hashfn, jattr,
        lambda: torch.argsort(rot_pack(keys, None, shards, vmin, skip, b,
                                       restbits, bias_bits, n)[0],
                              stable=True))


def _reorder(table: Table, jattr: int, hashfn: HashFunction,
             shards: Optional[Shards] = None) -> PartitionedTable:
    """One conflict-free partitioning pass: stable sort rows by the
    bucket id of ``hashfn`` (within a bucket by shard id, where ``shards``
    deals the rows to shards) and gather every column.

    This single program subsumes the reference's histogram + barrier +
    prefix-sum + scatter pipeline (partitioner.cpp:336-520): the histogram
    and offsets fall out of binary searches, and the scatter is the sort's
    gather.  The kv gate comes first: the stable path's bucket, shard and
    rank columns are made only where the split does not go through K7.
    """
    nparts = hashfn.buckets
    keys = table.key_column(jattr)
    num_cols = [c for c in table.columns if not is_strings(c)]
    int32_pair = (len(table.columns) == 2 and len(num_cols) == 2
                  and all(c.dtype == torch.int32 for c in num_cols))
    if (int32_pair
            and type(hashfn) is ModuloHash
            and _on_card(keys)
            and table.num_rows >= KV_MIN_ROWS
            and (shards is None or 1 <= shards.nthreads <= 256)):
        # Unlike the JAX gate, both columns must be numeric (a string
        # payload takes the stable path below).
        split = _kv_split(table, jattr, keys, hashfn, shards)
        if split is not None:
            return split
    buckets = hashfn.hash(keys)
    # int32 composite rank whenever it fits (bias values are shard ids
    # < nthreads): an int64 sort moves twice the bytes
    stride = 1 if shards is None else shards.nthreads
    if shards is None:
        rank = buckets.to(torch.int32)
    else:
        shard = shards.ids(table.num_rows, keys.device)
        if nparts * stride < (1 << 31):
            rank = buckets.to(torch.int32) * stride + shard
        else:
            rank = buckets.long() * stride + shard.long()
    if int32_pair:
        outs2, so = _reorder_device_packed2(tuple(num_cols), rank, nparts,
                                            stride)
        so = host(so)
        out = Table(table.schema, list(outs2), table.page_size)
        # same stable order as argsort(rank); materialized only if read
        return PartitionedTable(out, so[0], so[1], hashfn, jattr,
                                lambda: torch.argsort(rank, stable=True))
    outs, perm, so = _reorder_device(tuple(num_cols), rank, nparts, stride)
    so = host(so)
    # numeric columns gather AND STAY on the device; string columns gather
    # on the host
    outs = list(outs)
    out_cols = []
    perm_np = None
    for c in table.columns:
        if is_strings(c):
            if perm_np is None:
                perm_np = host(perm)
            out_cols.append(c[perm_np])
        else:
            out_cols.append(outs.pop(0))
    out = Table(table.schema, out_cols, table.page_size)
    return PartitionedTable(out, so[0], so[1], hashfn, jattr, perm)


class NoPartitioner:
    """'algorithm: "no"' — a single partition containing the whole input
    (Partitioner::split, partitioner.cpp:69-114)."""

    def __init__(self, hashfn: Optional[HashFunction] = None,
                 page_size: int = 1 << 20, attribute: int = 1,
                 nthreads: int = 1):
        self.hashfn = hashfn
        self.attribute = attribute

    def split(self, table: Table) -> PartitionedTable:
        n = table.num_rows
        return PartitionedTable(table, np.array([n], np.int64),
                                np.array([0], np.int64))


class ParallelPartitioner(NoPartitioner):
    """'algorithm: "parallel"' — all workers append to shared output
    partitions (partitioner.cpp:117-180): one stable reorder; stability
    gives the same arrival-order-within-partition observable."""

    def __init__(self, hashfn: HashFunction, page_size: int = 1 << 20,
                 attribute: int = 1, nthreads: int = 1):
        super().__init__(hashfn, page_size, attribute, nthreads)

    def split(self, table: Table) -> PartitionedTable:
        return _reorder(table, self.attribute, self.hashfn)


class IndependentPartitioner(ParallelPartitioner):
    """'algorithm: "independent"' — thread-private partitions concatenated
    per bucket (partitioner.cpp:183-263): the same reorder with a
    (shard, position) secondary rank so each of ``nthreads`` logical shards
    is contiguous within a partition, matching the reference's layout."""

    def __init__(self, hashfn: HashFunction, page_size: int = 1 << 20,
                 attribute: int = 1, nthreads: int = 8):
        super().__init__(hashfn, page_size, attribute, nthreads)
        self.nthreads = nthreads

    def split(self, table: Table) -> PartitionedTable:
        # the shard id orders rows within a bucket; sort stability keeps
        # original position within (bucket, shard)
        return _reorder(table, self.attribute, self.hashfn,
                        Shards(table.page_size, self.nthreads))


class DerekPartitioner(NoPartitioner):
    """'algorithm: "derek"' — contiguous equal split without hashing
    (partitioner.cpp:266-268: overrides split only)."""

    def __init__(self, hashfn: Optional[HashFunction] = None,
                 page_size: int = 1 << 20, attribute: int = 1,
                 nthreads: int = 8):
        super().__init__(hashfn, page_size, attribute, nthreads)
        self.nthreads = nthreads

    def split(self, table: Table) -> PartitionedTable:
        n = table.num_rows
        base, rem = divmod(n, self.nthreads)
        sizes = np.full((self.nthreads,), base, np.int64)
        sizes[:rem] += 1
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        return PartitionedTable(table, sizes, offsets)


class RadixPartitioner(ParallelPartitioner):
    """'algorithm: "radix"' — multi-pass MSB radix partitioning
    (partitioner.cpp:336-520: createhistogram / combinehistogram /
    realsplit loop over passes).

    Every pass is a stable sort on disjoint digit masks (hash.cpp
    generate()), so the composition over passes equals one stable sort on
    the full bucket id: the passes run as one reorder, and the per-pass
    functions honour the configured decomposition."""

    def __init__(self, hashfn: ModuloHash, page_size: int = 1 << 20,
                 attribute: int = 1, nthreads: int = 1, passes: int = 1):
        super().__init__(hashfn, page_size, attribute, nthreads)
        self.passes = passes
        self.pass_fns = (hashfn.generate(passes)
                         if isinstance(hashfn, ModuloHash) and passes > 1
                         else [hashfn])
        self.histogram: Optional[np.ndarray] = None  # FlatMemoryJoiner hook

    def split(self, table: Table) -> PartitionedTable:
        res = super().split(table)
        # inclusive histogram, as FlatMemoryJoiner::probe consumes it
        # (flatmem.cpp: bstart = histogram[curbuc-1], bitems = hist[b]-bstart)
        self.histogram = np.cumsum(res.sizes)
        return res


_PARTITIONERS = {
    "no": NoPartitioner,
    "parallel": ParallelPartitioner,
    "independent": IndependentPartitioner,
    "derek": DerekPartitioner,
    "radix": RadixPartitioner,
}


def partitioner_factory(node: dict, hash_node: dict, nthreads: int):
    """PartitionerFactory (partitionerfactory.cpp:23-42) from parsed conf:
    node = partitioner.build / partitioner.probe, hash_node =
    partitioner.hash."""
    algo = node["algorithm"]
    if algo not in _PARTITIONERS:
        raise ValueError(f"unknown partitioner {algo!r}")
    hashfn = hash_factory(hash_node) if algo != "no" else None
    kwargs = dict(page_size=node.get("pagesize", 1 << 20),
                  attribute=node.get("attribute", 1), nthreads=nthreads)
    if algo == "radix":
        kwargs["passes"] = node.get("passes", 1)
    return _PARTITIONERS[algo](hashfn, **kwargs)
