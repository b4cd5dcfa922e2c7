"""Synthetic relations for the banded join.

Counterparts of ``htm_hashjoin_tpu/data/generators.py`` (``sorted_keys``,
``shuffled_keys``, ``local_shuffled_keys``, ``zipf_keys``).  They keep its
distributions and invariants, not its bits (JAX's threefry stream cannot be
replayed in torch):

  * sorted, shuffled and local-shuffled keys are exact permutations of 1..N
    (int32), so a self join has N matches and both key sums are N(N+1)/2;
  * ``local_shuffled_keys`` moves every key less than ``window`` positions;
  * ``zipf_keys`` draws ranks by the same float32 closed-form inversion over
    a permuted alphabet, so every key lies in 1..alphabet_size;
  * equal seeds give equal keys on one device (a ``torch.Generator``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device or "cpu"))
    gen.manual_seed(seed)
    return gen


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
    gen = _generator(seed, keys.device)
    rank = torch.randint(0, window, (n,), generator=gen, dtype=torch.int32,
                         device=keys.device)
    rank += torch.arange(n, dtype=torch.int32, device=keys.device)
    order = torch.sort(rank, stable=True).indices
    return (order + 1).to(torch.int32)


def shuffled_keys(n: int, seed: int = 0, device=None) -> torch.Tensor:
    """1..N globally permuted (the reference's random_shuffle)."""
    gen = _generator(seed, device)
    perm = torch.randperm(n, generator=gen, device=gen.device)
    return (perm + 1).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _zipf_constants(alphabet_size: int, theta: float):
    """Host float64 normalisation scalars of the closed-form inversion
    (zeta(n, theta), zeta(2, theta), alpha, eta), as the JAX package
    computes them; the partial zeta is summed in chunks."""
    zeta_n = 0.0
    step = 1 << 22
    for lo in range(1, alphabet_size + 1, step):
        r = np.arange(lo, min(lo + step, alphabet_size + 1), dtype=np.float64)
        zeta_n += float(np.sum(r ** -theta))
    zeta2 = 1.0 + 0.5 ** theta
    alpha = 1.0 / (1.0 - theta) if theta != 1.0 else 0.0
    eta = ((1.0 - (2.0 / alphabet_size) ** (1.0 - theta)) /
           (1.0 - zeta2 / zeta_n)) if theta != 1.0 else 0.0
    return zeta_n, zeta2, alpha, eta


def _zipf_ranks(n: int, alphabet_size: int, theta: float,
                gen: torch.Generator) -> torch.Tensor:
    """Zipf(theta) ranks in 1..alphabet_size by the closed-form CDF
    inversion (Gray et al.'s formula, as YCSB's ZipfianGenerator), all in
    float32 on the generator's device, as the JAX package draws them.  At
    theta == 1 the formula sends every draw past rank 2 to the last rank,
    in both packages."""
    zeta_n, zeta2, alpha, eta = _zipf_constants(alphabet_size, theta)
    u = torch.rand(n, generator=gen, dtype=torch.float32, device=gen.device)
    u = torch.clamp(u, 1e-7, 1.0 - 1e-7)
    cont = torch.floor(alphabet_size * (eta * u - eta + 1.0) ** alpha)
    cont = torch.clamp(cont, 0, alphabet_size).to(torch.int32) + 1
    uz = u * zeta_n
    rank = torch.where(uz < 1.0, 1, torch.where(uz < zeta2, 2, cont))
    return torch.clamp(rank, 1, alphabet_size).to(torch.int32)


def zipf_keys(n: int, alphabet_size: int, theta: float, seed: int = 0,
              device=None) -> torch.Tensor:
    """Zipf(theta) keys over a permuted alphabet 1..alphabet_size (the
    reference permutes it so that hot keys are not the small integers):
    ranks by ``_zipf_ranks``, then one gather through a random permutation
    of the alphabet."""
    gen = _generator(seed, device)
    ranks = _zipf_ranks(n, alphabet_size, float(theta), gen)
    alphabet = torch.randperm(alphabet_size, generator=gen,
                              device=gen.device) + 1
    return alphabet[ranks.to(torch.int64) - 1].to(torch.int32)
