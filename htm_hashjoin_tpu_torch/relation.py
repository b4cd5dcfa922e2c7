"""Relations of the port: the ``Relation`` table and flat int32 key tensors.

``Relation`` is the counterpart of ``htm_hashjoin_tpu/relation.py``: a key
vector plus an optional payload vector (structure of arrays), with the
generator's sortedness hint.

The JAX package keeps tiled relations as ``(rows, 128)`` arrays (``r2d``,
``s2d``); the port keeps the same bytes flat.  The numpy helpers carry a
JAX package state across, so that a test can feed the port exactly the
bytes the JAX kernels saw, or probe the build artifact JAX made.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .constants import LANES

KEY_DTYPE = torch.int32   # keys are >= 1 (generators emit 1..N)


@dataclasses.dataclass
class Relation:
    """A join relation: int32 keys (values >= 1) and optional int32
    payloads, on one device.

    Mirrors relation_t (mc/src/types.h:41-46) with row ids implicit.
    ``assume_sorted`` is the generator's plan hint (S is constructed sorted
    for most driver distributions, main.cpp:93): a sorted probe side needs
    no device sort before the banded count."""

    keys: torch.Tensor
    payloads: Optional[torch.Tensor] = None
    assume_sorted: bool = False

    @property
    def num_tuples(self) -> int:
        return int(self.keys.numel())

    def key_sum(self) -> int:
        """Exact Σ keys: the ``inputSum`` conservation oracle
        (HTMHashBuild.hpp:312-320)."""
        return int(torch.sum(self.keys, dtype=torch.int64))

    def to_numpy(self) -> np.ndarray:
        return self.keys.cpu().numpy()

    def fence(self) -> "Relation":
        """Wait for the device work that made the relation, so that timed
        join phases exclude generation (the reference starts its timers
        after generate_data, main.cpp:113-118)."""
        if self.keys.is_cuda:
            torch.cuda.synchronize(self.keys.device)
        return self


def next_pow2(v: int) -> int:
    """Smallest power of two >= v (HTMHashBuild.hpp:25-37 bit-twiddle analog)."""
    if v <= 1:
        return 1
    return 1 << (v - 1).bit_length()


def keys_from_numpy(arr, device=None) -> torch.Tensor:
    """A 1-D int32 tensor on ``device`` holding ``arr``'s values."""
    a = np.asarray(arr)
    if a.ndim != 1:
        raise ValueError(f"expected a 1-D key array, got shape {a.shape}")
    if not np.array_equal(a, a.astype(np.int32)):
        raise ValueError("keys do not fit in int32")
    return torch.from_numpy(np.array(a, np.int32)).to(device)   # a copy


def tiles_from_numpy(arr2d, device=None) -> torch.Tensor:
    """The flat int32 tensor of a tiled ``(rows, 128)`` array (row-major, so
    ``out.view(-1, 128)`` gives the rows back)."""
    a = np.asarray(arr2d)
    if a.ndim != 2 or a.shape[1] != LANES:
        raise ValueError(f"expected a (rows, {LANES}) array, got shape {a.shape}")
    return keys_from_numpy(a.reshape(-1), device)


def banded_build_from_numpy(build, device=None):
    """The port's ``BandedBuild`` holding the same artifact as a JAX package
    ``BandedBuild`` (or any object with its fields: ``sorted2d``, ``mins``,
    ``maxs`` as arrays numpy can read, and ``tile``, ``n``, ``violations``,
    ``resorted``)."""
    from .joins.banded_backend import BandedBuild
    return BandedBuild(tiles_from_numpy(np.asarray(build.sorted2d), device),
                       keys_from_numpy(np.asarray(build.mins), device),
                       keys_from_numpy(np.asarray(build.maxs), device),
                       int(build.tile), int(build.n), int(build.violations),
                       bool(build.resorted))
