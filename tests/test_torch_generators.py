"""The port's shuffled and zipf generators: their invariants, and the same
distributions as the JAX package's (not the same bits: torch cannot replay
JAX's threefry stream)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from htm_hashjoin_tpu.data import generators as jgen
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
