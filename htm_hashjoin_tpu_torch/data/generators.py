"""Synthetic relations.

Counterparts of ``htm_hashjoin_tpu/data/generators.py``: every generator
``build_relations`` reaches, and ``build_relations`` itself.  They keep its
distributions and invariants, not its bits (JAX's threefry stream cannot be
replayed in torch):

  * sorted, shuffled, local-shuffled and pk keys are exact permutations of
    1..N (int32), so a self join has N matches and both key sums are
    N(N+1)/2;
  * local shuffles (of 1..N, of uniform and of random values) move every
    key less than ``window`` positions;
  * uniform keys lie in 1..distinct, random keys in 1..2^31 - 2, nonunique
    keys in 1..max_key;
  * fk keys take every pk key (or every key of a given relation) floor or
    ceil of s_size/r_size times, so PK ⋈ FK has s_size matches;
  * ``zipf_keys`` draws ranks by the same float32 closed-form inversion over
    a permuted alphabet, so every key lies in 1..alphabet_size;
  * equal seeds give equal keys on one device (a seeded ``torch.Generator``
    per draw, salted per distribution as the JAX package folds its key).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..config import Distribution, JoinConfig
from ..constants import MAXI32
from ..relation import KEY_DTYPE, Relation


def _generator(seed: int, device, salt: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, salt): the salt keeps
    two draws of one seed (values and jitter, R and S) apart, as the JAX
    package's ``fold_in`` does."""
    gen = torch.Generator(device=torch.device(device or "cpu"))
    gen.manual_seed(seed + (salt << 40))
    return gen


def _jitter_sort(vals: torch.Tensor, window: int,
                 gen: torch.Generator) -> torch.Tensor:
    """vals reordered by a stable sort of positions by ``i + U[0, window)``
    jitter: every value moves less than ``window`` places."""
    n = vals.numel()
    rank = torch.randint(0, window, (n,), generator=gen, dtype=torch.int32,
                         device=vals.device)
    rank += torch.arange(n, dtype=torch.int32, device=vals.device)
    return vals[torch.sort(rank, stable=True).indices]


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
    return _jitter_sort(keys, window, _generator(seed, keys.device))


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


def uniform_keys(n: int, distinct: int, window: int, seed: int,
                 device=None) -> torch.Tensor:
    """rand into [1, distinct], sorted, then the local-window shuffle
    (DataGen.hpp:30-54)."""
    vals = torch.randint(1, distinct + 1, (n,),
                         generator=_generator(seed, device, 3),
                         dtype=KEY_DTYPE, device=device)
    vals = torch.sort(vals).values
    if window <= 1:
        return vals
    return _jitter_sort(vals, window, _generator(seed, device, 4))


def random_keys(n: int, window: int, seed: int, device=None) -> torch.Tensor:
    """Full-positive-range rand in [1, 2^31 - 2], sorted, then the local
    shuffle (DataGen.hpp:55-71)."""
    vals = torch.randint(1, MAXI32, (n,), generator=_generator(seed, device, 5),
                         dtype=KEY_DTYPE, device=device)
    vals = torch.sort(vals).values
    if window <= 1:
        return vals
    return _jitter_sort(vals, window, _generator(seed, device, 6))


def pk_keys(n: int, seed: int, device=None) -> torch.Tensor:
    """Primary-key relation: 1..N shuffled (generator.c:240-260)."""
    return shuffled_keys(n, seed, device)


def pk_lshuffle_keys(n: int, window: int, seed: int,
                     device=None) -> torch.Tensor:
    """PK with a windowed local shuffle (generator.c:262-282)."""
    return local_shuffled_keys(n, window, seed, device)


def _tile_and_shuffle(vals: torch.Tensor, s_size: int,
                      seed: int) -> torch.Tensor:
    reps = -(-s_size // max(1, vals.numel()))
    tiled = vals.repeat(reps)[:s_size]
    gen = _generator(seed, vals.device, 7)
    return tiled[torch.randperm(s_size, generator=gen, device=vals.device)]


def fk_from_relation(r_keys: torch.Tensor, s_size: int,
                     seed: int) -> torch.Tensor:
    """Foreign keys drawn from an actual build relation's keys
    (create_relation_fk_from_pk, mc/src/generator.c:458-491): every R
    tuple's key appears floor or ceil of s_size/|R| times, shuffled, on
    R's device.  Needed when R is not a 1..N permutation (mc --full-range,
    main.c:393-395)."""
    return _tile_and_shuffle(r_keys, s_size, seed)


def fk_from_pk_keys(s_size: int, r_size: int, seed: int,
                    device=None) -> torch.Tensor:
    """Foreign keys from tiling the PK domain 1..r_size, then shuffling
    (generator.c:458-491): PK ⋈ FK has exactly s_size matches."""
    return _tile_and_shuffle(sorted_keys(r_size, device), s_size, seed)


def nonunique_keys(n: int, max_key: int, seed: int,
                   device=None) -> torch.Tensor:
    """Random keys in [1, max_key] with duplicates (generator.c:493-509)."""
    return torch.randint(1, max_key + 1, (n,),
                         generator=_generator(seed, device, 8),
                         dtype=KEY_DTYPE, device=device)


# ---------------------------------------------------------------------------
# Dispatch (DataGen.hpp:26 generate_data / main.cpp:89-97 relation setup)
# ---------------------------------------------------------------------------

def generate_keys(dist: Distribution, n: int, *, distinct: Optional[int] = None,
                  window: int = 16, seed: int = 0, r_size: Optional[int] = None,
                  zipf_param: float = 0.75, device=None) -> torch.Tensor:
    """generate_data(dist, size, distinct_keys, local_shuffle_range) analog
    (DataGen.hpp:26), on ``device``."""
    if dist == Distribution.SORTED:
        return sorted_keys(n, device)
    if dist == Distribution.SHUFFLE:
        return shuffled_keys(n, seed, device)
    if dist == Distribution.LOCAL_SHUFFLE:
        return local_shuffled_keys(n, window, seed, device)
    if dist == Distribution.UNIFORM:
        return uniform_keys(n, distinct or n, window, seed, device)
    if dist == Distribution.RANDOM:
        return random_keys(n, window, seed, device)
    if dist == Distribution.ZIPF:
        return zipf_keys(n, distinct or n, zipf_param, seed, device)
    if dist == Distribution.PK:
        return pk_keys(n, seed, device)
    if dist == Distribution.PK_LSHUFFLE:
        return pk_lshuffle_keys(n, window, seed, device)
    if dist == Distribution.FK:
        return fk_from_pk_keys(n, r_size or n, seed, device)
    if dist == Distribution.NONUNIQUE:
        return nonunique_keys(n, distinct or n, seed, device)
    raise ValueError(f"unknown distribution {dist}")


def build_relations(cfg: JoinConfig, device=None) -> tuple[Relation, Relation]:
    """Construct (R, S) on ``device`` by the driver's rules (main.cpp:89-97):
    S is sorted 1..s_size unless the distribution is random (S is then a
    copy of R) or zipf/fk (S is fk over R's domain).  ``cfg.s_distr``
    overrides the S side (the mc driver's -z zipf probe, --non-unique,
    mc/src/main.c:393-412), with the zipf/fk alphabet anchored to the R
    domain so that PK ⋈ S match counts stay exact."""
    r = generate_keys(cfg.data_distr, cfg.r_size, distinct=cfg.distinct_keys,
                      window=cfg.shuffle_range, seed=cfg.seed,
                      zipf_param=cfg.zipf_param, device=device)
    s_seed = cfg.s_seed if cfg.s_seed is not None else cfg.seed + 1
    if cfg.s_distr is not None:
        if cfg.s_distr == Distribution.FK:
            # draw from R's actual keys (fk_from_pk, generator.c:458-491):
            # needed when R itself has duplicates (mc --full-range)
            s_keys = fk_from_relation(r, cfg.s_size, s_seed)
        elif cfg.s_distr == Distribution.NONUNIQUE:
            # mc --non-unique S: maxid anchored to r_size (main.c:398-401)
            s_keys = nonunique_keys(cfg.s_size, cfg.r_size, s_seed, device)
        else:
            s_keys = generate_keys(cfg.s_distr, cfg.s_size,
                                   distinct=cfg.distinct_keys or cfg.r_size,
                                   window=cfg.shuffle_range, seed=s_seed,
                                   r_size=cfg.r_size,
                                   zipf_param=cfg.zipf_param, device=device)
        return (Relation(r),
                Relation(s_keys,
                         assume_sorted=cfg.s_distr == Distribution.SORTED))
    if cfg.data_distr == Distribution.RANDOM:
        reps = -(-cfg.s_size // max(1, cfg.r_size))
        s_keys = r.repeat(reps)[:cfg.s_size]
        s_sorted = False
    elif cfg.data_distr in (Distribution.ZIPF, Distribution.FK):
        s_keys = fk_from_pk_keys(cfg.s_size, cfg.r_size, s_seed, device)
        s_sorted = False
    else:
        s_keys = sorted_keys(cfg.s_size, device)
        s_sorted = True
    return Relation(r), Relation(s_keys, assume_sorted=s_sorted)
