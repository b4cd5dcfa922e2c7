"""The plain K2 (tile sort) and K3 (global sort) against the JAX package's
sort_tiles, tile_stats and global_sort_tiles (Pallas, interpret mode) on
the same numpy arrays, tile 2048.  Tolerance 0: integer outputs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from htm_hashjoin_tpu.joins.pallas_backend import to_tiles_2d_pow2
from htm_hashjoin_tpu.ops.pallas import join_kernels as jk
from htm_hashjoin_tpu_torch.constants import MAXI32
from htm_hashjoin_tpu_torch.joins.banded_backend import to_tiles_pow2
from htm_hashjoin_tpu_torch.ops import global_sort, sort_tiles
from htm_hashjoin_tpu_torch.relation import tiles_from_numpy

TILE = 2048


def tiles_input(kind):
    """Four tiles plus a padded fifth: displaced keys (up to 40 places),
    duplicates, keys over the whole int32 range with INT32_MIN, or
    displaced keys whose last two tiles are all MAXI32 padding."""
    rng = np.random.default_rng(3)
    n = 4 * TILE + 900
    if kind in ("displaced", "padding"):
        keys = (np.argsort(np.arange(n) + rng.integers(0, 41, n),
                           kind="stable") + 1).astype(np.int32)
        if kind == "padding":
            keys[3 * TILE:] = MAXI32
    elif kind == "negatives":
        keys = rng.integers(-2**31, MAXI32, n).astype(np.int32)
        keys[::97] = -2**31
    else:
        keys = rng.integers(-500, 500, n).astype(np.int32)
    pad = np.full(5 * TILE - n, MAXI32, np.int32)
    return np.concatenate([keys, pad]).reshape(-1, 128)


@pytest.mark.parametrize("kind", ["displaced", "duplicates", "negatives",
                                  "padding"])
@pytest.mark.parametrize("method,passes", [("bitonic", 1), ("bitonic_alt", 1),
                                           ("blocks", 16), ("oddeven", 4)])
def test_plain_k2_matches_jax_kernel(method, passes, kind):
    r2d = tiles_input(kind)
    j_sorted, j_stats = jk.sort_tiles(jnp.asarray(r2d), tile=TILE,
                                      method=method, passes=passes,
                                      interpret=True)
    got, stats = sort_tiles.sort_tiles(tiles_from_numpy(r2d), tile=TILE,
                                       method=method, passes=passes)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_sorted).reshape(-1))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(j_stats)[:, :3])
    if method in ("blocks", "oddeven"):
        assert stats[:, 2].sum() > 0           # the window was too small
    if kind == "padding":                      # an all-padding tile's row
        assert stats[3:].tolist() == [[MAXI32, -2**31, 0]] * 2
    if method == "bitonic_alt":
        v = got.view(-1, TILE)
        assert (v[1].diff() <= 0).all() and (v[2].diff() >= 0).all()


def test_tile_stats_takes_the_first_key_like_jax():
    """tile_stats reads each tile's FIRST key as its min: on a 'presorted'
    input that is not sorted, that is not the minimum."""
    r2d = tiles_input("duplicates")
    j_mins, j_maxs, j_viols = jk.tile_stats(jnp.asarray(r2d), TILE // 128)
    mins, maxs, viols = sort_tiles.tile_stats(tiles_from_numpy(r2d), TILE)
    np.testing.assert_array_equal(mins.numpy(), np.asarray(j_mins))
    np.testing.assert_array_equal(maxs.numpy(), np.asarray(j_maxs))
    np.testing.assert_array_equal(viols.numpy(), np.asarray(j_viols))
    assert (mins.numpy() != r2d.reshape(-1, TILE).min(1)).any()
    assert viols.dtype == torch.int64


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("n", [2048, 6000, 16384])
def test_plain_k3_matches_jax_and_numpy(n, dup):
    rng = np.random.default_rng(n + dup)
    keys = (rng.integers(0, 700, n) if dup
            else rng.permutation(n) + 1).astype(np.int32)
    want = np.asarray(jk.global_sort_tiles(to_tiles_2d_pow2(
        jnp.asarray(keys), TILE), tile=TILE, interpret=True)).reshape(-1)
    got = global_sort.global_sort_tiles(
        to_tiles_pow2(torch.from_numpy(keys), TILE), tile=TILE).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:n], np.sort(keys))
    assert (got[n:] == MAXI32).all()


def test_k3_needs_a_power_of_two_tile_count():
    keys = torch.arange(3 * TILE, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        global_sort.global_sort_tiles(keys, tile=TILE)


@pytest.mark.parametrize("tile", [4096, 32768])
def test_plain_k2_takes_large_tiles(tile):
    """K2 holds no band, so its tiles go up to 32768 keys (the global
    sort's phase-A block)."""
    keys = torch.from_numpy(np.random.default_rng(1).permutation(2 * tile)
                            .astype(np.int32))
    got, stats = sort_tiles.sort_tiles(keys, tile=tile, method="bitonic_alt")
    v = got.view(2, tile)
    assert torch.equal(v[0], torch.sort(keys.view(2, tile)[0]).values)
    assert torch.equal(v[1], torch.sort(keys.view(2, tile)[1],
                                        descending=True).values)
    assert stats[:, 2].tolist() == [0, 0]
