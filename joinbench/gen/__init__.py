"""The benchmark's own key generators, one module a distribution, found by
the name a traffic file gives (``load``).

A generator module defines ``SORTED`` (the relation is handed to the join
with ``assume_sorted``, as the port's ``build_relations`` marks a sorted
S) and ``keys(n, cfg, rng, state)``, which returns ``n`` int32 keys drawn
from the ``torch.Generator`` ``rng`` on its device.  It may define
``prepare(cfg, seed, device)``: state made once a run (a table, an
alphabet), passed to every ``keys`` call.
"""

from __future__ import annotations

import hashlib
import importlib

import torch


def load(name: str):
    """The generator module ``joinbench.gen.<name>``."""
    if not name.isidentifier():
        raise ValueError(f"not a generator name: {name!r}")
    return importlib.import_module(f"{__name__}.{name}")


def stream_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one stream, from the run's seed and the stream's
    name (join index, side): equal arguments give equal seeds, and no two
    streams of a run share one."""
    text = ":".join(map(str, (seed, *parts))).encode()
    digest = hashlib.blake2b(text, digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def generator(seed: int, device, *parts) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded for one stream."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(stream_seed(seed, *parts))
    return gen
