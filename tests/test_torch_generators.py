"""The port's generators: their invariants (permutations, window bounds, fk
multiplicity, value ranges, build_relations' driver rules), and the same
distributions as the JAX package's (not the same bits: torch cannot replay
JAX's threefry stream)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from htm_hashjoin_tpu import config as jconfig
from htm_hashjoin_tpu.data import generators as jgen
from htm_hashjoin_tpu_torch.config import Distribution, JoinConfig
from htm_hashjoin_tpu_torch.data import generators as gen


@pytest.mark.parametrize("n", [1, 1000, 1 << 14])
def test_shuffled_keys_is_a_seeded_permutation(n):
    keys = gen.shuffled_keys(n, 3)
    assert keys.dtype == torch.int32 and keys.shape == (n,)
    np.testing.assert_array_equal(np.sort(keys.numpy()), np.arange(1, n + 1))
    assert torch.equal(keys, gen.shuffled_keys(n, 3))
    if n > 1:
        assert not torch.equal(keys, gen.shuffled_keys(n, 4))


@pytest.mark.parametrize("alphabet,theta", [(1 << 14, 0.75), (1 << 14, 1.0),
                                            (1 << 12, 1.25), (1000, 0.5)])
def test_zipf_keys_lie_in_the_alphabet_and_repeat_by_seed(alphabet, theta):
    keys = gen.zipf_keys(1 << 15, alphabet, theta, 7)
    assert keys.dtype == torch.int32 and keys.shape == (1 << 15,)
    assert int(keys.min()) >= 1 and int(keys.max()) <= alphabet
    assert torch.equal(keys, gen.zipf_keys(1 << 15, alphabet, theta, 7))
    assert not torch.equal(keys, gen.zipf_keys(1 << 15, alphabet, theta, 8))


@pytest.mark.parametrize("theta", [0.75, 1.0, 1.25])
def test_zipf_top_rank_frequency(theta):
    """Rank 1 is drawn with probability 1/zeta(n, theta): within 5 % of it
    over 2^18 draws (about 7 standard deviations at theta 0.75)."""
    n = 1 << 14
    g = torch.Generator()
    g.manual_seed(11)
    ranks = gen._zipf_ranks(1 << 18, n, theta, g)
    want = 1.0 / gen._zipf_constants(n, theta)[0]
    assert abs(float((ranks == 1).double().mean()) / want - 1.0) < 0.05


def test_zipf_constants_match_jax():
    for theta in (0.75, 1.0, 1.25):
        assert gen._zipf_constants(5000, theta) == \
            jgen._zipf_constants(5000, theta)


@pytest.mark.parametrize("theta", [0.75, 1.0, 1.25])
def test_zipf_rank_distribution_matches_jax(theta):
    """The same closed form in float32: the frequencies of ranks 1 and 2,
    of the last rank and the number of distinct ranks agree with the JAX
    generator's within sampling noise (at theta 1.0 the formula sends every
    draw past rank 2 to the last rank, in both packages)."""
    n, draws = 1 << 12, 1 << 16
    g = torch.Generator()
    g.manual_seed(5)
    got = gen._zipf_ranks(draws, n, theta, g).numpy()
    want = np.asarray(jgen._zipf_ranks(draws, n, theta, 5))
    for rank in (1, 2, n):
        p = max((want == rank).mean(), 1.0 / draws)
        assert abs((got == rank).mean() - p) < 6 * np.sqrt(p / draws) + 1e-9
    distinct_got, distinct_want = len(np.unique(got)), len(np.unique(want))
    assert abs(distinct_got - distinct_want) <= 0.05 * distinct_want + 1


# ---------------------------------------------------------------------------
# The generators build_relations reaches, and its driver rules
# ---------------------------------------------------------------------------

def displaced_within(out, window):
    """Every key of ``out`` lies within ``window - 1`` places of where the
    sorted order holds an equal key (duplicates allowed)."""
    srt = np.sort(out)
    n = len(out)
    lo = srt[np.maximum(np.arange(n) - window + 1, 0)]
    hi = srt[np.minimum(np.arange(n) + window - 1, n - 1)]
    return bool(np.all((lo <= out) & (out <= hi)))


@pytest.mark.parametrize("window", [1, 16, 600])
def test_uniform_keys_range_and_window(window):
    keys = gen.uniform_keys(1 << 14, 1000, window, 3)
    a = keys.numpy()
    assert keys.dtype == torch.int32 and a.min() >= 1 and a.max() <= 1000
    assert len(np.unique(a)) > 900                   # duplicates, all used
    assert displaced_within(a, window)
    assert torch.equal(keys, gen.uniform_keys(1 << 14, 1000, window, 3))
    if window == 1:
        assert np.all(np.diff(a) >= 0)


@pytest.mark.parametrize("window", [1, 64])
def test_random_keys_full_range_and_window(window):
    keys = gen.random_keys(1 << 14, window, 4)
    a = keys.numpy().astype(np.int64)
    assert a.min() >= 1 and a.max() <= 2**31 - 2 and a.max() > 2**30
    assert displaced_within(a, window)
    assert not torch.equal(keys, gen.random_keys(1 << 14, window, 5))


@pytest.mark.parametrize("window", [4, 512])
def test_pk_keys_are_permutations(window):
    n = 5000
    for keys in (gen.pk_keys(n, 2), gen.pk_lshuffle_keys(n, window, 2)):
        np.testing.assert_array_equal(np.sort(keys.numpy()),
                                      np.arange(1, n + 1))
    moved = gen.pk_lshuffle_keys(n, window, 2).numpy() - np.arange(1, n + 1)
    assert np.abs(moved).max() < window


@pytest.mark.parametrize("s_size,r_size", [(8192, 1024), (1000, 1024),
                                           (3000, 1000)])
def test_fk_multiplicity(s_size, r_size):
    keys = gen.fk_from_pk_keys(s_size, r_size, 6).numpy()
    counts = np.bincount(keys, minlength=r_size + 1)[1:]
    assert len(keys) == s_size and keys.min() >= 1 and keys.max() <= r_size
    assert counts.min() >= s_size // r_size
    assert counts.max() <= -(-s_size // r_size)
    assert counts.sum() == s_size


def test_fk_from_relation_draws_the_relations_keys():
    r = gen.nonunique_keys(1000, 2**31 - 2, 7)
    s = gen.fk_from_relation(r, 2500, 8).numpy()
    reps = np.sort(np.concatenate([r.numpy()] * 3)[:2500])
    np.testing.assert_array_equal(np.sort(s), reps)


def test_nonunique_keys_range():
    keys = gen.nonunique_keys(1 << 14, 100, 9).numpy()
    assert keys.min() >= 1 and keys.max() <= 100 and len(np.unique(keys)) == 100


def test_generate_keys_covers_every_distribution():
    for dist in Distribution:
        keys = gen.generate_keys(dist, 4096, distinct=512, window=16, seed=1,
                                 r_size=2048)
        assert keys.dtype == torch.int32 and keys.shape == (4096,)
        assert int(keys.min()) >= 1


@pytest.mark.parametrize("dist,s_rule", [
    ("sorted", "sorted"), ("shuffle", "sorted"), ("local_shuffle", "sorted"),
    ("uniform", "sorted"), ("pk", "sorted"), ("nonunique", "sorted"),
    ("random", "copy"), ("zipf", "fk"), ("fk", "fk")])
def test_build_relations_driver_rules(dist, s_rule):
    """S is sorted 1..s_size, a copy of R (random) or fk over R's domain
    (zipf, fk), as the JAX build_relations (main.cpp:89-97)."""
    cfg = JoinConfig(r_size=4096, s_size=3000, data_distr=Distribution(dist),
                     seed=2)
    r, s = gen.build_relations(cfg)
    assert r.keys.shape == (4096,) and s.keys.shape == (3000,)
    assert s.assume_sorted == (s_rule == "sorted")
    if s_rule == "sorted":
        np.testing.assert_array_equal(s.to_numpy(), np.arange(1, 3001))
    elif s_rule == "copy":
        assert torch.equal(s.keys, r.keys[:3000])
    else:
        counts = np.bincount(s.to_numpy(), minlength=4097)[1:]
        assert counts.max() == 1 and counts.sum() == 3000


def test_build_relations_mc_overrides_match_the_jax_rules():
    """-z (zipf S over the PK alphabet), fk over R's actual keys, and
    --non-unique's S alphabet anchored to r_size; the JAX package's keys
    differ in their bits, not in these invariants."""
    r, s = gen.build_relations(JoinConfig(
        r_size=2048, s_size=4096, data_distr=Distribution.PK,
        s_distr=Distribution.ZIPF, zipf_param=0.9))
    assert int(s.keys.max()) <= 2048 and not s.assume_sorted
    r, s = gen.build_relations(JoinConfig(
        r_size=2048, s_size=4096, data_distr=Distribution.NONUNIQUE,
        distinct_keys=2**31 - 2, s_distr=Distribution.FK))
    assert set(s.to_numpy().tolist()) <= set(r.to_numpy().tolist())
    r, s = gen.build_relations(JoinConfig(
        r_size=1024, s_size=2048, data_distr=Distribution.NONUNIQUE,
        s_distr=Distribution.NONUNIQUE))
    assert int(s.keys.max()) <= 1024
    jr, js = jgen.build_relations(jconfig.JoinConfig(
        r_size=1024, s_size=2048,
        data_distr=jconfig.Distribution.NONUNIQUE,
        s_distr=jconfig.Distribution.NONUNIQUE))
    assert int(jnp.max(js.keys)) <= 1024 and js.assume_sorted == s.assume_sorted
