"""Hash functions (counterpart of ``htm_hashjoin_tpu/ops/hashing.py``).

The reference uses three: the locality-preserving ``(key/3) & mask``
(HTMHashBuild.hpp:122,180), identity ``key & mask`` (AtomicHashBuild.hpp:44,
NoCCHashBuild.hpp:43) and a Murmur 32-bit finalizer (include/DataGen.hpp:
14-23).  mc radix hashing is ``(key & mask) >> skip`` and a per-pass digit
(mc/src/prj_params.h:76-78).

torch's ``//`` and ``%`` on integer tensors floor, as ``jnp``'s do, so the
locality hash agrees on negative keys too.  torch has no full uint32
arithmetic: ``murmur32`` runs in int64 and keeps 32 bits after every step.
"""

from __future__ import annotations

import torch

_LOW32 = 0xFFFFFFFF


def locality_hash(keys: torch.Tensor, mask: int) -> torch.Tensor:
    """(key // 3) & mask: consecutive keys share a 3-slot bucket
    (HTMHashBuild.hpp:122)."""
    return (keys // 3) & mask


def identity_hash(keys: torch.Tensor, mask: int) -> torch.Tensor:
    """key & mask (AtomicHashBuild.hpp:44)."""
    return keys & mask


# the hashes that the scatter tables' kernels compute themselves, by their
# kind there (csrc/hash_table.cuh)
_KERNEL_KINDS = {identity_hash: 1, locality_hash: 2}


def kernel_hash(keys: torch.Tensor, hash_fn, mask: int):
    """(kind, h) for a scatter-table kernel: the hash's kind and None where
    the kernel computes it itself, else 0 and the int32 hash values it is
    handed."""
    kind = _KERNEL_KINDS.get(hash_fn, 0)
    return kind, (None if kind else
                  hash_fn(keys, mask).to(torch.int32).contiguous())


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32), in int64 without overflow: the
    constant is split into 16-bit halves, so no product reaches 2^48."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _LOW32


def murmur32(keys: torch.Tensor) -> torch.Tensor:
    """Murmur3 32-bit finalizer (DataGen.hpp:14-23) of int32 keys, as int32
    in [0, 2^31): the low 31 bits of the uint32 hash, as JAX takes them."""
    h = keys.to(torch.int64) & _LOW32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h & 0x7FFFFFFF).to(torch.int32)


def radix_digit(keys: torch.Tensor, shift: int, bits: int, *,
                hashed: bool = False) -> torch.Tensor:
    """The radix digit of a partitioning pass (mc/src/prj_params.h:76-78;
    mc/src/parallel_radix_join.c:559-627)."""
    h = murmur32(keys) if hashed else keys
    return (h >> shift) & ((1 << bits) - 1)
