"""The port's plain tile sorters against the JAX package's in-kernel
networks (run in a one-tile Pallas kernel in interpret mode).

Inputs are displaced up to 200 places, far past most windows tested, so
the inexact outputs of the optimistic sorters must match too.  All
comparisons are exact (integer keys).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from htm_hashjoin_tpu.ops.pallas import linops
from htm_hashjoin_tpu_torch.ops import sorters

SHAPE = (16, 128)          # one 2048-key tile
L = SHAPE[0] * SHAPE[1]
DISPLACEMENT = 200


def run_kernel(fn, x):
    """fn over one VMEM tile in a Pallas interpret-mode kernel."""
    def kernel(x_ref, o_ref):
        o_ref[:] = fn(x_ref[:])

    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(x)


def displaced_tiles(n_tiles, seed):
    """n_tiles tiles of 1..L, each key moved up to DISPLACEMENT places."""
    rng = np.random.default_rng(seed)
    base = np.arange(L)
    return np.stack([
        (np.argsort(base + rng.integers(0, DISPLACEMENT + 1, L), kind="stable")
         + 1).astype(np.int32) for _ in range(n_tiles)])


def jax_rows(fn, tiles):
    return np.stack([np.asarray(run_kernel(fn, jnp.asarray(t.reshape(SHAPE))))
                     .reshape(-1) for t in tiles])


@pytest.mark.parametrize("window", [4, 9, 16, 40])
def test_shifted_block_sort_matches_linops(window):
    tiles = displaced_tiles(2, window)
    want = jax_rows(lambda a: linops.shifted_block_sort_keys(a, window), tiles)
    got = sorters.shifted_block_sort_tiles(torch.from_numpy(tiles), window)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.diff(want, axis=1) < 0).any()      # the window was too small


@pytest.mark.parametrize("passes", [1, 4, 8])
def test_odd_even_passes_match_linops(passes):
    tiles = displaced_tiles(2, 100 + passes)
    want = jax_rows(lambda a: linops.odd_even_passes_keys(a, passes), tiles)
    got = sorters.odd_even_passes_tiles(torch.from_numpy(tiles), passes)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.diff(want, axis=1) < 0).any()


def test_bitonic_sort_matches_linops():
    rng = np.random.default_rng(7)
    tiles = rng.integers(0, 500, (2, L)).astype(np.int32)   # duplicates too
    want = jax_rows(linops.bitonic_sort_keys, tiles)
    got = sorters.bitonic_sort_tiles(torch.from_numpy(tiles))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window", [1, 16, 512, 1024])
def test_shifted_block_sort_exact_within_window(window):
    """Staircase lemma: displacement <= window sorts exactly, including the
    block capped at the tile (window 1024 -> one full-tile block)."""
    rng = np.random.default_rng(window)
    keys = np.argsort(np.arange(L) + rng.integers(0, window, L),
                      kind="stable").astype(np.int32)
    got = sorters.shifted_block_sort_tiles(torch.from_numpy(keys[None]),
                                           window)
    np.testing.assert_array_equal(got.numpy()[0], np.arange(L))


def test_sort_tiles_rejects_unknown_method():
    with pytest.raises(ValueError):
        sorters.sort_tiles(torch.zeros((1, L), dtype=torch.int32), "radix", 1)
