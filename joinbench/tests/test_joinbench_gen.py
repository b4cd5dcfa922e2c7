"""The benchmark's generators: what each distribution guarantees."""

import types

import numpy as np
import pytest
import torch

from joinbench import gen


def _cfg(**kw):
    base = dict(r_size=1 << 12, s_size=1 << 12, shuffle_range=16,
                zipf_param=1.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _keys(name, n, cfg, seed=5, index=0, side="r"):
    g = gen.load(name)
    state = g.prepare(cfg, seed, "cpu") if hasattr(g, "prepare") else None
    return g.keys(n, cfg, gen.generator(seed, "cpu", index, side), state)


def test_sorted_is_one_to_n():
    k = _keys("sorted", 1000, _cfg())
    assert k.dtype == torch.int32
    assert torch.equal(k, torch.arange(1, 1001, dtype=torch.int32))
    assert gen.load("sorted").SORTED


@pytest.mark.parametrize("window", [1, 2, 16, 512])
def test_local_shuffle_moves_every_key_less_than_the_window(window):
    n = 1 << 16
    k = _keys("local_shuffle", n, _cfg(shuffle_range=window))
    assert k.dtype == torch.int32
    assert torch.equal(torch.sort(k).values,
                       torch.arange(1, n + 1, dtype=torch.int32))
    moved = (k.long() - 1 - torch.arange(n)).abs()
    assert int(moved.max()) < window
    if window >= 16:
        assert int(moved.max()) > 0


@pytest.mark.parametrize("name", ["shuffle", "pk"])
def test_shuffle_and_pk_are_permutations(name):
    n = 1 << 15
    k = _keys(name, n, _cfg())
    assert k.dtype == torch.int32
    assert torch.equal(torch.sort(k).values,
                       torch.arange(1, n + 1, dtype=torch.int32))
    assert not torch.equal(k, torch.sort(k).values)
    assert not gen.load(name).SORTED


def test_fk_takes_each_key_exactly_s_over_r_times():
    cfg = _cfg(r_size=1000)
    k = _keys("fk", 16 * 1000 + 7, cfg, side="s")
    counts = torch.bincount(k.long(), minlength=1001)[1:]
    assert int(counts.min()) == 16 and int(counts.max()) == 17
    assert int((counts == 17).sum()) == 7
    for b in range(16):     # whole permutations, one after another
        block = k[b * 1000:(b + 1) * 1000]
        assert torch.equal(torch.sort(block).values,
                           torch.arange(1, 1001, dtype=torch.int32))


def test_fk_at_the_cells_ratio():
    cfg = _cfg(r_size=1 << 10)
    k = _keys("fk", 1 << 14, cfg, side="s")
    assert torch.equal(torch.bincount(k.long())[1:],
                       torch.full((1 << 10,), 16))


def test_zipf_frequencies_follow_the_exact_distribution():
    alphabet, theta, n = 64, 1.0, 1 << 20
    cfg = _cfg(r_size=alphabet, zipf_param=theta)
    k = _keys("zipf", n, cfg, side="s")
    assert int(k.min()) >= 1 and int(k.max()) <= alphabet
    p = 1.0 / np.arange(1, alphabet + 1) ** theta
    p /= p.sum()
    freq = np.sort(np.bincount(k.numpy(), minlength=alphabet + 1)[1:])[::-1]
    sigma = np.sqrt(n * p * (1 - p))
    assert np.all(np.abs(freq - n * p) < 6 * sigma + 3)


def test_zipf_table_and_top_key_share():
    cfg = _cfg(r_size=1 << 16, zipf_param=1.0)
    cdf = gen.load("zipf").prepare(cfg, 1, "cpu")
    harmonic = float(np.sum(1.0 / np.arange(1, (1 << 16) + 1)))
    assert abs(float(cdf[0]) - 1.0 / harmonic) < 1e-12
    assert abs(float(cdf[-1]) - 1.0) < 1e-12
    assert bool(torch.all(cdf[1:] >= cdf[:-1]))


def test_zipf_draws_many_distinct_keys():
    # the port's closed form gives 3 distinct keys at theta 1; the table
    # and binary search give the heavy tail
    cfg = _cfg(r_size=4096, zipf_param=1.0)
    k = _keys("zipf", 1 << 18, cfg, side="s")
    assert int(torch.unique(k).numel()) > 2000


def test_zipf_alphabet_changes_from_relation_to_relation():
    cfg = _cfg(r_size=4096, zipf_param=1.0)
    top = [int(torch.mode(_keys("zipf", 1 << 16, cfg, index=i,
                                side="s")).values) for i in range(4)]
    assert len(set(top)) > 1


@pytest.mark.parametrize("name", ["sorted", "shuffle", "pk", "local_shuffle",
                                  "fk", "zipf"])
def test_equal_streams_give_equal_keys(name):
    cfg = _cfg()
    a = _keys(name, 4096, cfg, seed=2**31 + 11, index=3)
    b = _keys(name, 4096, cfg, seed=2**31 + 11, index=3)
    assert torch.equal(a, b)
    if name != "sorted":
        c = _keys(name, 4096, cfg, seed=2**31 + 11, index=4)
        assert not torch.equal(a, c)


def test_stream_seeds_differ_and_take_large_seeds():
    seeds = {gen.stream_seed(s, i, side) for s in (0, 2**31 + 5, 2**40)
             for i in range(8) for side in "rs"}
    assert len(seeds) == 48
    assert all(0 <= s < 2**63 for s in seeds)


def test_load_refuses_a_path():
    with pytest.raises(ValueError):
        gen.load("../reference")
