"""K1's plain torch version against the JAX package's fused_sort_count
(Pallas, interpret mode) on the same r2d / s2d / row_off / rows_needed.

Sorted output, stats lanes 0-2 and flags lane 0 must agree exactly on every
case; the match count must agree exactly wherever the sorter left no
inversions (the JAX kernel's merge assumes a sorted tile, and its callers
discard the count and retry otherwise).  The per-tile key sums, summed,
must equal the JAX join's out_sum and in_sum, and the plain prepass's
per-tile min/max JAX's ``_tile_minmax``.  Tolerance 0: integer outputs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from htm_hashjoin_tpu.joins.pallas_backend import (_banded_join_device,
                                                   _slice_offsets,
                                                   _tile_minmax,
                                                   prepare_probe_side,
                                                   to_tiles_2d)
from htm_hashjoin_tpu.ops.pallas.join_kernels import LANES, fused_sort_count
from htm_hashjoin_tpu_torch.ops.fused_sort_count import fused_sort_count_ref
from htm_hashjoin_tpu_torch.ops.tile_minmax import tile_minmax_ref
from htm_hashjoin_tpu_torch.relation import keys_from_numpy, tiles_from_numpy

TILE = 2048
N = 1 << 14


def local_shuffle(n, window, seed):
    """1..n, each key moved less than `window` places (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    return (np.argsort(np.arange(n) + rng.integers(0, window, n),
                       kind="stable") + 1).astype(np.int32)


def case(name):
    """(rkeys, sorted skeys, method, passes, unique_both) by name."""
    rng = np.random.default_rng(11)
    s_unique = np.arange(1, N + 1, dtype=np.int32)
    if name == "unique_blocks_w16":
        return local_shuffle(N, 16, 1), s_unique, "blocks", 16, True
    if name == "unique_bitonic":
        return local_shuffle(N, 16, 2), s_unique, "bitonic", 1, False
    if name == "padded_last_tile_oddeven":
        n = N - 77
        return (local_shuffle(n, 4, 3), np.arange(1, n + 1, dtype=np.int32),
                "oddeven", 4, True)
    if name == "duplicates_blocks_w8":
        dup = np.repeat(np.arange(1, N // 2 + 1, dtype=np.int32), 2)
        return dup[local_shuffle(N, 8, 4) - 1], dup, "blocks", 8, False
    if name == "duplicates_random_bitonic":
        return (rng.integers(1, N // 3, N).astype(np.int32),
                np.sort(rng.integers(1, N // 3, N).astype(np.int32)),
                "bitonic", 1, False)
    if name == "underestimated_window":
        return local_shuffle(N, 64, 0), s_unique, "oddeven", 4, False
    if name == "heavy_s_run":
        s = np.sort(np.concatenate([s_unique, np.full(6000, 100, np.int32)]))
        return local_shuffle(N, 8, 7), s, "oddeven", 8, False
    raise KeyError(name)


CASES = ["unique_blocks_w16", "unique_bitonic", "padded_last_tile_oddeven",
         "duplicates_blocks_w8", "duplicates_random_bitonic",
         "underestimated_window", "heavy_s_run"]


def jax_inputs(rkeys, skeys):
    r2d = to_tiles_2d(jnp.asarray(rkeys), TILE)
    s2d = prepare_probe_side(jnp.asarray(skeys), TILE)
    mins, maxs = _tile_minmax(r2d, TILE // LANES)
    off, end = _slice_offsets(jnp.asarray(skeys), mins, maxs)
    row_off = (off // LANES).astype(jnp.int32)
    rows_needed = jnp.maximum((end + LANES - 1) // LANES - row_off,
                              0).astype(jnp.int32)
    return r2d, s2d, row_off, rows_needed


@pytest.mark.parametrize("name", CASES)
def test_plain_k1_matches_jax_kernel(name):
    rkeys, skeys, method, passes, unique = case(name)
    r2d, s2d, row_off, rows_needed = jax_inputs(rkeys, skeys)
    j_sorted, j_stats, j_counts, j_flags = fused_sort_count(
        r2d, s2d, row_off, rows_needed, tile=TILE, method=method,
        passes=passes, unique_both=unique, interpret=True)

    sorted_flat, stats, counts, flags, in_sums, out_sums = fused_sort_count_ref(
        tiles_from_numpy(np.asarray(r2d)), tiles_from_numpy(np.asarray(s2d)),
        keys_from_numpy(np.asarray(row_off)),
        keys_from_numpy(np.asarray(rows_needed)), tile=TILE, method=method,
        passes=passes, unique_both=unique)

    np.testing.assert_array_equal(sorted_flat.numpy(),
                                  np.asarray(j_sorted).reshape(-1))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(j_stats)[:, :3])
    np.testing.assert_array_equal(flags.numpy(), np.asarray(j_flags)[:, 0])
    assert int(in_sums.sum()) == int(out_sums.sum())
    violations = int(stats[:, 2].sum())
    if violations == 0:
        assert int(counts.sum()) == int(np.asarray(j_counts, np.int64).sum())
    if name == "underestimated_window":
        assert violations > 0
    if name == "heavy_s_run":
        assert flags[0] == 1 and counts[0] == 0
    if name == "unique_blocks_w16":
        assert int(counts.sum()) == N and not flags.any()


@pytest.mark.parametrize("name", CASES)
def test_plain_k1_sums_match_jax_join_sums(name):
    """K1's per-tile input and output key sums, summed, are the JAX join's
    in_sum and out_sum on the fused narrow plan."""
    rkeys, skeys, method, passes, unique = case(name)
    r2d, s2d, row_off, rows_needed = jax_inputs(rkeys, skeys)
    want = _banded_join_device(r2d, s2d, jnp.asarray(skeys), tile=TILE,
                               method=method, passes=passes, max_chunks=16,
                               unique_both=unique, narrow=True,
                               interpret=True)
    out = fused_sort_count_ref(
        tiles_from_numpy(np.asarray(r2d)), tiles_from_numpy(np.asarray(s2d)),
        keys_from_numpy(np.asarray(row_off)),
        keys_from_numpy(np.asarray(rows_needed)), tile=TILE, method=method,
        passes=passes)
    in_sums, out_sums = out[4], out[5]
    assert in_sums.dtype == out_sums.dtype == torch.int64
    assert int(out_sums.sum()) == int(want[3])
    assert int(in_sums.sum()) == int(want[4])


def minmax_keys(kind):
    """Unsorted keys for the prepass: a padded last tile, a tile of MAXI32
    only, negatives with INT32_MIN and MAXI32, duplicates."""
    rng = np.random.default_rng(13)
    if kind == "padded_last_tile":
        return local_shuffle(N - 300, 16, 1)
    if kind == "padding_tile":
        keys = local_shuffle(N, 64, 2)
        keys[TILE:2 * TILE] = np.iinfo(np.int32).max
        return keys
    if kind == "negatives":
        keys = rng.integers(-2**31, 2**31 - 1, N).astype(np.int32)
        keys[::97] = np.iinfo(np.int32).min
        keys[5::89] = np.iinfo(np.int32).max
        return keys
    return rng.integers(1, 40, N).astype(np.int32)


@pytest.mark.parametrize("kind", ["padded_last_tile", "padding_tile",
                                  "negatives", "duplicates"])
def test_plain_tile_minmax_matches_jax(kind):
    r2d = to_tiles_2d(jnp.asarray(minmax_keys(kind)), TILE)
    mins, maxs = _tile_minmax(r2d, TILE // LANES)
    t_mins, t_maxs = tile_minmax_ref(tiles_from_numpy(np.asarray(r2d)), TILE)
    np.testing.assert_array_equal(t_mins.numpy(), np.asarray(mins))
    np.testing.assert_array_equal(t_maxs.numpy(), np.asarray(maxs))
    if kind == "padding_tile":
        assert t_mins[1] == np.iinfo(np.int32).max
        assert t_maxs[1] == np.iinfo(np.int32).min
