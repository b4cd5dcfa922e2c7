"""The arithmetic of the LSD radix sort behind K3 and K7
(``csrc/radix_sort.cu``), through its plain model ``ops/radix_sort.py``:
held exactly to ``torch.sort(stable=True)`` (keys, and the values it
gathers), to the port's wrappers on the CPU, and to the JAX package's
``global_sort_tiles`` / ``global_sort_kv_tiles`` in interpret mode on the
same numpy inputs (keys exactly; values by the multiset rule, since the
TPU's network is not stable).  Tile 2048 on the JAX side.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from htm_hashjoin_tpu.ops.pallas import join_kernels as jk
from htm_hashjoin_tpu_torch.constants import MAXI32
from htm_hashjoin_tpu_torch.ops import global_sort as gs
from htm_hashjoin_tpu_torch.ops import global_sort_kv as gkv
from htm_hashjoin_tpu_torch.ops import radix_sort as rs
from htm_hashjoin_tpu_torch.wisconsin import partitioner as wpart

TILE = 2048
INT32_MIN = -2**31


def case_keys(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "negatives":
        keys = rng.integers(INT32_MIN, MAXI32, n)
    elif kind == "INT32_MIN and MAXI32":
        keys = rng.choice([INT32_MIN, INT32_MIN + 1, -1, 0, MAXI32 - 1,
                           MAXI32], n)
    elif kind == "MAXI32 padding":
        keys = np.concatenate([rng.permutation(n - n // 3) + 1,
                               np.full(n // 3, MAXI32)])
    elif kind == "all equal":
        keys = np.full(n, -7)
    elif kind == "two distinct":
        keys = rng.choice([3, -5], n)
    elif kind == "16 copies a key":
        keys = rng.integers(0, n // 16, n)
    else:                                   # rotation-packed, 3 shard bits
        v = torch.from_numpy(rng.integers(1, 1 << 24, n).astype(np.int32))
        shard = (torch.arange(n, dtype=torch.int32) // 512) % 8
        return wpart._rot_pack(v, shard, 1, 17, 6, 19, 3, n).numpy()
    return keys.astype(np.int32)


KINDS = ["negatives", "INT32_MIN and MAXI32", "MAXI32 padding", "all equal",
         "two distinct", "16 copies a key", "rotation-packed"]
CASES = [(kind, n_tiles) for kind in KINDS for n_tiles in (1, 8)]


def pairs(keys, vals):
    """The (key, value) multiset of a sort's output, per key."""
    k = np.asarray(keys).reshape(-1).astype(np.int64)
    v = np.asarray(vals).reshape(-1).astype(np.int64)
    return np.sort((k << 32) | (v & 0xFFFFFFFF))


@pytest.mark.parametrize("kind,n_tiles", CASES)
def test_keys_sort_matches_torch_and_jax(kind, n_tiles):
    keys = case_keys(kind, n_tiles * TILE, n_tiles)
    t = torch.from_numpy(keys)
    got, none = rs.model_sort(t)
    assert none is None
    want = torch.sort(t, stable=True).values
    assert torch.equal(got, want)
    assert torch.equal(gs.global_sort_tiles(t, tile=TILE), want)
    jax_out = jk.global_sort_tiles(jnp.asarray(keys.reshape(-1, jk.LANES)),
                                   tile=TILE, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_out).reshape(-1))


@pytest.mark.parametrize("kind,n_tiles", CASES)
def test_pairs_sort_matches_torch_and_jax(kind, n_tiles):
    keys = case_keys(kind, n_tiles * TILE, n_tiles + 100)
    vals = np.random.default_rng(n_tiles).integers(
        INT32_MIN, MAXI32, keys.size).astype(np.int32)
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    got_k, got_v = rs.model_sort(tk, tv)
    want_k, order = torch.sort(tk, stable=True)
    assert torch.equal(got_k, want_k) and torch.equal(got_v, tv[order])
    wrapped = gkv.global_sort_kv_tiles(tk, tv, tile=TILE)
    assert torch.equal(wrapped[0], got_k) and torch.equal(wrapped[1], got_v)
    jax_k, jax_v = jk.global_sort_kv_tiles(
        jnp.asarray(keys.reshape(-1, jk.LANES)),
        jnp.asarray(vals.reshape(-1, jk.LANES)), tile=TILE, interpret=True)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(jax_k).reshape(-1))
    np.testing.assert_array_equal(pairs(got_k, got_v), pairs(jax_k, jax_v))


@pytest.mark.parametrize("n,items,threads", [
    (1, 16, 256), (3, 1, 64), (777, 1, 64), (5000, 2, 256),
    (6144, 24, 256), (6145, 24, 256), (40_000, 4, 128)])
def test_many_tiles_and_ragged_tails(n, items, threads):
    """Small model tiles give many tiles, so the look-back's scan across
    tiles and the masked last tile both carry weight."""
    keys = torch.from_numpy(case_keys("16 copies a key", max(n, 16), n)[:n])
    vals = torch.arange(n, dtype=torch.int32)
    got_k, got_v = rs.model_sort(keys, vals, items=items, threads=threads)
    want_k, order = torch.sort(keys, stable=True)
    assert torch.equal(got_k, want_k) and torch.equal(got_v, order.int())


def test_sign_flip_preserves_order():
    keys = torch.tensor([INT32_MIN, INT32_MIN + 1, -1, 0, 1, MAXI32 - 1,
                         MAXI32], dtype=torch.int32)
    u = rs.flip(keys)
    assert u.tolist() == [0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2,
                          2**32 - 1]
    assert rs.digits(u, rs.PASSES - 1).tolist() == [0, 0, 127, 128, 128,
                                                    255, 255]


def test_histograms_count_every_digit_of_every_key():
    keys = torch.from_numpy(case_keys("negatives", 5000, 3))
    u = rs.flip(keys)
    hist = rs.histograms(u)
    assert hist.shape == (rs.PASSES, rs.BINS)
    assert (hist.sum(1) == keys.numel()).all()
    for p in range(rs.PASSES):
        assert hist[p, 17] == int(((u >> (8 * p)) & 255).eq(17).sum())


def test_tile_ranks_are_stable_within_each_tile():
    """pos is each key's place in its tile's digit-ordered staging: a
    permutation of the tile, equal keys' places in input order; the last
    tile's masked keys are not counted."""
    d = torch.from_numpy(np.random.default_rng(4).integers(0, 5, 1000))
    counts, pos = rs.tile_ranks(d, items=2, threads=64)      # tile 128
    assert counts.shape == (8, rs.BINS) and int(counts.sum()) == 1000
    for t in range(8):
        seg = slice(128 * t, min(128 * (t + 1), 1000))
        p, dd = pos[seg], d[seg]
        assert sorted(p.tolist()) == list(range(dd.numel()))
        assert torch.equal(dd[torch.argsort(p)], torch.sort(dd).values)
        for digit in range(5):
            assert (p[dd == digit].diff() > 0).all()
        assert torch.equal(counts[t, :5], torch.bincount(dd, minlength=5))


def test_lookback_sums_the_earlier_tiles():
    """A key's destination is its bucket start plus its digit's count over
    earlier tiles plus its place in its own tile's run: the one-tile model
    (no look-back) and the 64-key-tile model agree on every pass."""
    keys = torch.from_numpy(case_keys("16 copies a key", 3000, 6))
    hist = rs.histograms(rs.flip(keys))
    for p in range(rs.PASSES):
        one = rs.scatter_pass(keys, None, p, hist[p], items=94, threads=32)
        many = rs.scatter_pass(keys, None, p, hist[p], items=1, threads=64)
        assert torch.equal(one[0], many[0])


def test_four_passes_end_in_the_output_buffer():
    """LSD order matters: sorting by the digits most significant first
    would not sort, and an odd pass count would leave the output a pass
    behind."""
    assert rs.PASSES == 4 and rs.PASSES % 2 == 0
    keys = torch.from_numpy(case_keys("negatives", 3000, 7))
    hist = rs.histograms(rs.flip(keys))
    src = keys
    for p in reversed(range(rs.PASSES)):
        src, _ = rs.scatter_pass(src, None, p, hist[p])
    assert not torch.equal(src, torch.sort(keys).values)
    assert torch.equal(rs.model_sort(keys)[0], torch.sort(keys).values)


def test_tile_matches_the_kernel_constants():
    assert rs.TILE_KEYS == rs.THREADS * rs.ITEMS == 6144
    assert rs.THREADS == rs.BINS
    with pytest.raises(ValueError, match="2\\^32"):
        rs._check_size("x", rs.MAX_KEYS)


@pytest.mark.parametrize("n", [(1 << 29) + 1, 1 << 30, 1 << 31,
                               (1 << 32) - 1])
def test_size_check_takes_sorts_past_2_to_the_30(n):
    """The look-back status words are 64 bits since the 2^30-key cap was
    lifted: a padded 2^29 + 1 sort (2^30 keys) and 2^31 keys pass the check;
    2^32 keys (past the 32-bit offsets) do not."""
    rs._check_size("x", n)
    with pytest.raises(ValueError, match="fewer than 2\\^32 keys"):
        rs._check_size("x", n + (1 << 32) - (n & ((1 << 32) - 1)))

