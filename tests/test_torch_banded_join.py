"""The port's banded join on the fused narrow plan against the JAX
package's (Pallas kernels in interpret mode) on the same numpy inputs, at
tile 2048 and N = 2^14.

Every field of the outcome must agree exactly: matches, violations,
overflow (flagged) tiles, both key sums and whether the bitonic retry ran.
The other plans are held to JAX in tests/test_torch_plans.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from htm_hashjoin_tpu.joins import pallas_backend as jpb
from htm_hashjoin_tpu_torch.constants import INT32_MIN
from htm_hashjoin_tpu_torch.joins import banded_backend as tpb

TILE = 2048
N = 1 << 14


def local_shuffle(n, window, seed):
    """1..n, each key moved less than `window` places (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    return (np.argsort(np.arange(n) + rng.integers(0, window, n),
                       kind="stable") + 1).astype(np.int32)


def both(rkeys, skeys, **kw):
    """The JAX outcome and the port's, on the same arrays."""
    want = jpb.banded_join_pipelined(jnp.asarray(rkeys), jnp.asarray(skeys),
                                     tile=TILE, interpret=True, **kw)
    got = tpb.banded_join_pipelined(torch.from_numpy(rkeys),
                                    torch.from_numpy(skeys), tile=TILE, **kw)
    return want, got


def assert_same(want, got):
    assert tuple(got) == tuple(want)
    assert all(type(x) is type(y) for x, y in zip(got, want))


@pytest.mark.parametrize("unique_both", [False, True])
@pytest.mark.parametrize("window", [4, 8, 16, 512])
def test_join_matches_jax_unique_keys(window, unique_both):
    rkeys = local_shuffle(N, window, window)
    want, got = both(rkeys, np.arange(1, N + 1, dtype=np.int32),
                     locality_window=window, unique_both=unique_both)
    assert_same(want, got)
    assert got.matches == N and not got.resorted
    assert got.output_sum == got.input_sum == N * (N + 1) // 2


@pytest.mark.parametrize("window", [8, 16])
def test_join_matches_jax_duplicate_keys(window):
    dup = np.repeat(np.arange(1, N // 2 + 1, dtype=np.int32), 2)
    rkeys = dup[local_shuffle(N, window, 20 + window) - 1]
    want, got = both(rkeys, dup, locality_window=window)
    assert_same(want, got)
    assert got.matches == 2 * N and got.overflow_tiles == 0


def test_join_matches_jax_padded_last_tile():
    n = N - 77
    want, got = both(local_shuffle(n, 8, 1), np.arange(1, n + 1, dtype=np.int32),
                     locality_window=8)
    assert_same(want, got)
    assert got.matches == n


def test_join_matches_jax_forced_retry():
    """Window-64 data under locality_window=4: the optimistic odd-even sort
    leaves violations, the one readback sees them, the bitonic retry runs."""
    want, got = both(local_shuffle(N, 64, 0), np.arange(1, N + 1, dtype=np.int32),
                     locality_window=4)
    assert_same(want, got)
    assert got.resorted and got.violations > 0 and got.matches == N


@pytest.mark.parametrize("window,unique_both", [(16, True), (4, False)])
def test_enqueue_bundle_matches_jax(window, unique_both):
    """The fence-free enqueue's five scalars (matches, violations, flagged,
    out_sum, in_sum) against the JAX device chain of the same plan."""
    rkeys = local_shuffle(N - 5, window, 3)
    skeys = np.arange(1, N - 4, dtype=np.int32)
    want = jpb.enqueue_full_join(jnp.asarray(rkeys), jnp.asarray(skeys),
                                 tile=TILE, locality_window=window,
                                 unique_both=unique_both, narrow=True,
                                 interpret=True)
    got = tpb.enqueue_banded_join(torch.from_numpy(rkeys),
                                  torch.from_numpy(skeys), tile=TILE,
                                  locality_window=window,
                                  unique_both=unique_both)
    assert [int(x) for x in got[:5]] == [int(x) for x in want[:5]]
    np.testing.assert_array_equal(got[5].numpy(),
                                  np.asarray(want[5]).reshape(-1))
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(want[7]))


def test_band_geometry_matches_jax():
    """Padding, per-tile min/max and band rows in 128-key granularity."""
    rkeys = local_shuffle(N - 77, 16, 5)
    skeys = np.arange(1, N + 1, dtype=np.int32)
    r2d = jpb.to_tiles_2d(jnp.asarray(rkeys), TILE)
    s2d = jpb.prepare_probe_side(jnp.asarray(skeys), TILE)
    mins, maxs = jpb._tile_minmax(r2d, TILE // 128)
    off, end = jpb._slice_offsets(jnp.asarray(skeys), mins, maxs)

    r_flat = tpb.to_tiles(torch.from_numpy(rkeys), TILE)
    s_t = torch.from_numpy(skeys)
    np.testing.assert_array_equal(r_flat.numpy(), np.asarray(r2d).reshape(-1))
    np.testing.assert_array_equal(tpb.prepare_probe_side(s_t, TILE).numpy(),
                                  np.asarray(s2d).reshape(-1))
    t_mins, t_maxs = tpb.tile_minmax(r_flat, TILE)
    np.testing.assert_array_equal(t_mins.numpy(), np.asarray(mins))
    np.testing.assert_array_equal(t_maxs.numpy(), np.asarray(maxs))
    t_off, t_end, row_off, rows_needed = tpb.band_rows(r_flat, s_t, TILE)
    np.testing.assert_array_equal(t_off.numpy(), np.asarray(off))
    np.testing.assert_array_equal(t_end.numpy(), np.asarray(end))
    np.testing.assert_array_equal(row_off.numpy(), np.asarray(off) // 128)
    np.testing.assert_array_equal(
        rows_needed.numpy(),
        np.maximum((np.asarray(end) + 127) // 128 - np.asarray(off) // 128, 0))


def test_fully_padded_tile_gets_an_empty_band():
    """A tile of padding only: min MAXI32, max INT32_MIN, band at S's end
    with zero rows, readable thanks to the end padding."""
    keys = torch.arange(1, 101, dtype=torch.int32)
    r_flat = torch.cat([tpb.to_tiles(keys, TILE),
                        torch.full((TILE,), tpb.MAXI32, dtype=torch.int32)])
    _, _, row_off, rows_needed = tpb.band_rows(r_flat, keys, TILE)
    assert row_off.tolist() == [0, 0] and rows_needed.tolist() == [1, 0]
    mins, maxs = tpb.tile_minmax(r_flat, TILE)
    assert mins[1] == tpb.MAXI32 and maxs[1] == INT32_MIN


@pytest.mark.parametrize("window", [None, 0, 1, 4, 8, 9, 16, 512, 513, 1024,
                                    2000])
@pytest.mark.parametrize("tile", [2048, 8192])
def test_sort_method_matches_jax(window, tile):
    assert tpb._sort_method(window, tile) == jpb._sort_method(window, tile)


def test_short_probe_padding_raises():
    keys = torch.arange(1, N + 1, dtype=torch.int32)
    short = tpb.to_tiles(keys, TILE)[:N]
    with pytest.raises(ValueError, match="prepare_probe_side"):
        tpb.banded_join_pipelined(keys, keys, tile=TILE, locality_window=16,
                                  s2d=short)
