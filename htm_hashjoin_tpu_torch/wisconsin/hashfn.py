"""Vectorized hash-function objects on tensors — mc/wisconsin-src/hash.{h,cpp}.

Counterpart of ``htm_hashjoin_tpu/wisconsin/hashfn.py``, value for value:
each ``hash`` maps a whole key tensor (or anything ``torch.as_tensor``
takes) to an int32 bucket tensor on the keys' device.  Bucket counts round
to the next power of two (hash.cpp getlogarithm, HashFunction ctor).

``ModuloHash.generate(passes)`` reproduces the multi-pass radix
decomposition (hash.cpp ModuloHashFunction::generate): pass i consumes the
top ``bits/passes`` bits via a larger skip, the last pass the remainder,
and the per-pass masks are disjoint and union to the full mask.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def _log2_next_pow2(k: int) -> int:
    if k <= 1:
        return 1 if k == 1 else 0
    return int(np.ceil(np.log2(k)))


class HashFunction:
    """Base: rounds bucket count to next pow2 (hash.cpp:40-48)."""

    def __init__(self, vmin: int, vmax: int, k: int):
        self._min = vmin
        self._max = vmax
        # reference: k==0 or k==1 -> _k = 1 (i.e. 2 buckets); else ceil log2
        self._log2k = 1 if k <= 1 else _log2_next_pow2(k)

    def fingerprint(self) -> tuple:
        """Structural identity: two factory-built hash functions with equal
        fingerprints map every key to the same bucket.  The driver builds
        the build- and probe-side partitioners from the SAME conf node
        (partitioner.hash) but as distinct objects; the joiner's
        partition-local probe gate (probe unit p searches only build
        partition p, probe.inl:18-36) keys on this."""
        return (type(self).__name__, self._min, self._max, self._log2k,
                getattr(self, "_skipbits", 0))

    def __eq__(self, other):
        return (isinstance(other, HashFunction)
                and self.fingerprint() == other.fingerprint())

    def __hash__(self):
        return hash(self.fingerprint())

    @property
    def buckets(self) -> int:
        return 1 << self._log2k

    def hash(self, values) -> torch.Tensor:
        raise NotImplementedError


class RangePartitionHash(HashFunction):
    """((v - min) << log2k) / (max - min + 1)  (hash.h:53-63)."""

    def hash(self, values) -> torch.Tensor:
        v = (torch.as_tensor(values).long() - self._min) << self._log2k
        return torch.div(v, self._max - self._min + 1,
                         rounding_mode="floor").to(torch.int32)


class ModuloHash(HashFunction):
    """((v - min) & mask) >> skipbits with mask = (2^log2k - 1) << skipbits
    (hash.h:65-91)."""

    def __init__(self, vmin: int, vmax: int, k: int, skipbits: int = 0):
        super().__init__(vmin, vmax, k)
        self._skipbits = skipbits
        self._mask = ((1 << self._log2k) - 1) << skipbits

    @property
    def buckets(self) -> int:
        return (self._mask >> self._skipbits) + 1

    def hash(self, values) -> torch.Tensor:
        v = torch.as_tensor(values)
        if (v.dtype == torch.int32 and abs(self._min) < (1 << 31)
                and self._mask < (1 << 31)):
            # int32 end to end: (v & mask) reads only the low bits, which
            # agree between int32 and its sign-extended int64 — bit-exact,
            # at half the bytes of the int64 path
            return ((v - self._min) & self._mask) >> self._skipbits
        v = v.long() - self._min
        return ((v & self._mask) >> self._skipbits).to(torch.int32)

    def generate(self, passes: int) -> List["ModuloHash"]:
        """Disjoint per-pass digit extractors for multi-pass radix
        partitioning (hash.cpp ModuloHashFunction::generate)."""
        total_bits = self._log2k
        per_pass = total_bits // passes
        fns: List[ModuloHash] = []
        for i in range(passes - 1):
            fns.append(ModuloHash(
                self._min, self._max, 1 << per_pass,
                self._skipbits + total_bits - (i + 1) * per_pass))
        last_bits = total_bits - (passes - 1) * per_pass
        fns.append(ModuloHash(self._min, self._max, 1 << last_bits,
                              self._skipbits))
        return fns


class MagicHash(ModuloHash):
    """TPC-H o_orderkey workaround: (((v>>2) & ~7) | (v&7)) & mask
    (hash.h:93-106)."""

    def __init__(self, vmin: int, vmax: int, k: int):
        super().__init__(vmin, vmax, k, 0)

    def hash(self, values) -> torch.Tensor:
        v = torch.as_tensor(values).long()
        not7 = torch.bitwise_not(torch.tensor(7, dtype=torch.int64,
                                              device=v.device))
        h = ((v >> 2) & not7) | (v & 7)
        return (h & self._mask).to(torch.int32)


def hash_factory(node: dict) -> HashFunction:
    """HashFactory::createHashFunction (hash.cpp:51-73) from a parsed conf
    group: {fn, range: [min,max], buckets, skipbits?}."""
    k = node["buckets"]
    vmin, vmax = node["range"][0], node["range"][1]
    name = node["fn"]
    if name == "range":
        return RangePartitionHash(vmin, vmax, k)
    if name == "modulo":
        return ModuloHash(vmin, vmax, k, node.get("skipbits", 0))
    if name == "magic":
        return MagicHash(vmin, vmax, k)
    raise ValueError(f"unknown hash fn {name!r}")
