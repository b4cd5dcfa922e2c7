"""Synthetic relations for the banded join (the two distributions of the
headline workload).

Counterparts of ``htm_hashjoin_tpu/data/generators.py`` (``sorted_keys``,
``local_shuffled_keys``).  They keep its invariants, not its bits (JAX's
threefry stream cannot be replayed in torch):

  * both return an exact permutation of 1..N (int32), so a self join has N
    matches and both key sums are N(N+1)/2;
  * ``local_shuffled_keys`` moves every key less than ``window`` positions;
  * equal seeds give equal keys on one device.
"""

from __future__ import annotations

import torch


def sorted_keys(n: int, device=None) -> torch.Tensor:
    """1..N in order."""
    return torch.arange(1, n + 1, dtype=torch.int32, device=device)


def local_shuffled_keys(n: int, window: int, seed: int,
                        device=None) -> torch.Tensor:
    """1..N with bounded-window displacement: a stable sort of positions by
    ``i + U[0, window)`` jitter, drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``."""
    keys = sorted_keys(n, device)
    if window <= 1:
        return keys
    gen = torch.Generator(device=keys.device)
    gen.manual_seed(seed)
    rank = torch.randint(0, window, (n,), generator=gen, dtype=torch.int32,
                         device=keys.device)
    rank += torch.arange(n, dtype=torch.int32, device=keys.device)
    order = torch.sort(rank, stable=True).indices
    return (order + 1).to(torch.int32)
