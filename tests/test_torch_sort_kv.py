"""K7, the key-value global sort: the port's plain versions
(``global_sort_kv_ref`` behind ``global_sort_kv_tiles``, and K7a's
``sort_kv_tiles_ref``) against the JAX package's Pallas kv sort in
interpret mode, on the same numpy inputs; and K7a's kernel design, sorting
(key, row) composites, in a plain model against ``sort_kv_tiles_ref``.

The TPU network is not stable on equal keys (join_kernels.py:732-734), so
the port is held to the output by the multiset rule: the keys equal, and
within each key the values equal as a multiset (checked as the sorted
int64 composites key << 32 | value).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from htm_hashjoin_tpu.ops.pallas import join_kernels as jk
from htm_hashjoin_tpu_torch.constants import MAXI32
from htm_hashjoin_tpu_torch.ops import global_sort_kv as gkv
from htm_hashjoin_tpu_torch.ops import sort_kv_tiles as skv

TILE = 2048


def pairs(keys, vals):
    """The (key, value) multiset of a sort's output, per key."""
    k = np.asarray(keys).reshape(-1).astype(np.int64)
    v = np.asarray(vals).reshape(-1).astype(np.int64)
    return np.sort((k << 32) | (v & 0xFFFFFFFF))


def kv_inputs(n_tiles, seed, pad=0):
    rng = np.random.default_rng(seed)
    n = n_tiles * TILE
    keys = rng.integers(0, max(1, n // 16), n).astype(np.int32)  # ~16 copies
    keys[n - pad:] = MAXI32
    vals = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    return keys, vals


@pytest.mark.parametrize("n_tiles,pad", [(1, 0), (2, 300), (4, 0),
                                         (8, 2 * TILE + 5)])
def test_global_sort_kv_matches_interpret_kernel(n_tiles, pad):
    keys, vals = kv_inputs(n_tiles, n_tiles, pad)
    jk_keys, jk_vals = jk.global_sort_kv_tiles(
        jnp.asarray(keys.reshape(-1, jk.LANES)),
        jnp.asarray(vals.reshape(-1, jk.LANES)), tile=TILE, interpret=True)
    before = (gkv.LAUNCHES, skv.LAUNCHES)
    got_k, got_v = gkv.global_sort_kv_tiles(torch.from_numpy(keys),
                                            torch.from_numpy(vals), tile=TILE)
    assert (gkv.LAUNCHES, skv.LAUNCHES) == before     # plain path on the CPU
    np.testing.assert_array_equal(got_k.numpy(),
                                  np.asarray(jk_keys).reshape(-1))
    np.testing.assert_array_equal(pairs(got_k, got_v),
                                  pairs(jk_keys, jk_vals))
    np.testing.assert_array_equal(pairs(got_k, got_v), pairs(keys, vals))


@pytest.mark.parametrize("method", ["bitonic", "bitonic_alt"])
def test_sort_kv_tiles_matches_interpret_phase_a(method):
    keys, vals = kv_inputs(4, 7)
    jk_keys, jk_vals = jk._sort_kv_tiles_jit(
        jnp.asarray(keys.reshape(-1, jk.LANES)),
        jnp.asarray(vals.reshape(-1, jk.LANES)), tile=TILE, method=method,
        interpret=True)
    got_k, got_v = skv.sort_kv_tiles(torch.from_numpy(keys),
                                     torch.from_numpy(vals), tile=TILE,
                                     alternate=method == "bitonic_alt")
    want_k = np.asarray(jk_keys).reshape(-1, TILE)
    want_v = np.asarray(jk_vals).reshape(-1, TILE)
    np.testing.assert_array_equal(got_k.view(-1, TILE).numpy(), want_k)
    for t in range(4):
        np.testing.assert_array_equal(
            pairs(got_k.view(-1, TILE)[t], got_v.view(-1, TILE)[t]),
            pairs(want_k[t], want_v[t]))


def test_plain_sort_is_stable_and_gathers_values():
    keys = torch.tensor([3, 1, 3, 2, 1, 3, MAXI32, MAXI32] * 256,
                        dtype=torch.int32)
    vals = torch.arange(keys.numel(), dtype=torch.int32)
    got_k, got_v = gkv.global_sort_kv_tiles(keys, vals, tile=TILE)
    want_k, order = torch.sort(keys, stable=True)
    assert torch.equal(got_k, want_k) and torch.equal(got_v, order.int())


@pytest.mark.parametrize("bad", ["tiles", "length", "dtype", "tile"])
def test_bad_arguments_raise(bad):
    keys, vals = (torch.zeros(3 * TILE, dtype=torch.int32) if bad == "tiles"
                  else torch.zeros(2 * TILE, dtype=torch.int32),
                  torch.zeros(2 * TILE, dtype=torch.int32))
    if bad == "tiles":
        vals = torch.zeros(3 * TILE, dtype=torch.int32)
    elif bad == "length":
        vals = vals[:-4]
    elif bad == "dtype":
        vals = vals.long()
    kw = dict(tile=3000 if bad == "tile" else TILE)
    with pytest.raises(ValueError):
        gkv.global_sort_kv_tiles(keys, vals, **kw)


K7A_KINDS = ["all equal", "sorted", "reversed", "16 copies a key",
             "MAXI32 padding in the last block", "INT32_MIN and negatives"]


def k7a_case(kind, tile, n_tiles, seed=0):
    """(keys, values) of n_tiles tiles: the edges of a stable block sort in
    both directions (ties everywhere, runs in and against the sort's
    direction, the split's padding, the sign and the complement's ends).
    The values are distinct, so a tie out of input order shows."""
    rng = np.random.default_rng(seed)
    n = tile * n_tiles
    wide = rng.integers(-2**31, 2**31, n, dtype=np.int64)
    if kind == "all equal":
        keys = np.full(n, -7)
    elif kind == "sorted":
        keys = np.sort(wide // 2**20)          # about 2 copies a key
    elif kind == "reversed":
        keys = np.sort(wide // 2**20)[::-1]
    elif kind == "16 copies a key":
        keys = rng.integers(0, max(1, n // 16), n)
    elif kind == "MAXI32 padding in the last block":
        keys = rng.integers(0, max(1, n // 16), n)
        keys[n - tile // 2 - 5:] = MAXI32
    else:
        keys = wide.copy()
        keys[::97] = -2**31
        keys[1::89] = MAXI32
        keys[2::13] = -1
    vals = rng.permutation(n) - n // 2
    return (torch.from_numpy(keys.astype(np.int32)),
            torch.from_numpy(vals.astype(np.int32)))


def composite_sort_model(keys, vals, tile, alternate):
    """K7a's design in plain torch: each key becomes (k << 32) | row, ~k on
    a descending tile, row its index in the tile; the composites are sorted
    ascending; the keys are the high words (complemented back), the values
    gathered by the low words."""
    k = keys.view(-1, tile).long()
    if alternate:
        k[1::2] = ~k[1::2]
    comp = (k << 32) | torch.arange(tile)
    comp = torch.sort(comp, dim=1).values
    high = (comp >> 32).int()
    if alternate:
        high[1::2] = ~high[1::2]
    rows = comp & 0xFFFFFFFF
    assert int(rows.max()) < tile
    return (high.reshape(-1),
            torch.gather(vals.view(-1, tile), 1, rows).reshape(-1))


@pytest.mark.parametrize("tile", skv.KERNEL_TILES)
@pytest.mark.parametrize("alternate", [False, True])
@pytest.mark.parametrize("kind", K7A_KINDS)
@pytest.mark.parametrize("n_tiles", [1, 64])
def test_composite_model_equals_plain_sort(tile, alternate, kind, n_tiles):
    """The composite packing gives the stable sort bit for bit, descending
    tiles too: catches sign, complement and tie-order faults in the
    kernel's design before the card runs it."""
    keys, vals = k7a_case(kind, tile, n_tiles, seed=tile + n_tiles)
    got = composite_sort_model(keys, vals, tile, alternate)
    want = skv.sort_kv_tiles_ref(keys, vals, tile=tile, alternate=alternate)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
