"""Every plan of the port's banded_join_pipelined against the JAX package's
(Pallas kernels in interpret mode) on the same numpy inputs, at tile 2048
and N = 2^14: sort-first (presort), presorted, unsorted probe side
(sort_s, zipf S), wide band (narrow=False), no locality window, the
flagged-tile repair and the mass-overflow replans.

Each field of the outcome must agree exactly (matches, violations, overflow
tiles, both key sums, whether a retry or replan ran), and the match count
must equal an exact numpy count.  Tolerance 0: integer outputs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from htm_hashjoin_tpu.joins import pallas_backend as jpb
from htm_hashjoin_tpu_torch.joins import banded_backend as tpb
from htm_hashjoin_tpu_torch.ops import global_sort

TILE = 2048
N = 1 << 14


def local_shuffle(n, window, seed):
    """1..n, each key moved less than `window` places (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    return (np.argsort(np.arange(n) + rng.integers(0, window, n),
                       kind="stable") + 1).astype(np.int32)


def numpy_matches(r, s):
    """Exact equi-join count: sum over keys of count_R * count_S."""
    kr, cr = np.unique(r, return_counts=True)
    ks, cs = np.unique(s, return_counts=True)
    _, ir, i_s = np.intersect1d(kr, ks, return_indices=True)
    return int(np.sum(cr[ir].astype(np.int64) * cs[i_s]))


def zipf_s(n, theta, seed):
    """A zipf probe side over the alphabet 1..N, unsorted (numpy)."""
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.0 + theta, n), N)
    return rng.permutation(N).astype(np.int32)[ranks - 1] + 1


def inputs(name):
    """(rkeys, skeys, plan kwargs) by name; skeys is sorted unless sort_s."""
    rng = np.random.default_rng(17)
    perm = (rng.permutation(N) + 1).astype(np.int32)
    s_sorted = np.arange(1, N + 1, dtype=np.int32)
    dup = np.sort(rng.integers(1, N // 4, N).astype(np.int32))
    if name == "presort":
        return perm, s_sorted, dict(presort=True)
    if name == "presort_unique_narrow":
        return perm, s_sorted, dict(presort=True, unique_both=True)
    if name == "presort_duplicates":
        return rng.permutation(dup), dup, dict(presort=True)
    if name == "presorted":
        return s_sorted.copy(), s_sorted, dict(presorted=True)
    if name == "presorted_padded_duplicates":
        return dup[:N - 77], dup, dict(presorted=True)
    if name == "presorted_heavy_run_mass_tagged":
        # a 9000-copy run over tiles 0-4: five bands of 5 chunks > 2
        heavy = np.sort(np.concatenate([np.arange(1, N - 8999, dtype=np.int32),
                                        np.full(9000, 7, np.int32)]))
        return heavy, heavy, dict(presorted=True, max_chunks=2)
    if name.startswith("sort_s_zipf"):
        theta = float(name.rsplit("_", 1)[1])
        return perm, zipf_s(N, theta, 5), dict(sort_s=True, presort=True)
    if name == "sort_s_fk_locality_repair":
        # every R key twice in S: all four bands are twice the narrow window
        fk = rng.permutation(np.tile(s_sorted[:N // 2], 2))
        return local_shuffle(N // 2, 16, 2), fk, dict(sort_s=True,
                                                      locality_window=16)
    if name == "wide_bitonic_w600":
        return local_shuffle(N, 600, 3), s_sorted, dict(locality_window=600,
                                                        narrow=False)
    if name == "wide_blocks_w16":
        return local_shuffle(N, 16, 4), s_sorted, dict(locality_window=16,
                                                       narrow=False)
    if name == "wide_retry_oddeven":
        return local_shuffle(N, 64, 0), s_sorted, dict(locality_window=4,
                                                       narrow=False)
    if name == "no_window_duplicates":
        return rng.permutation(dup), s_sorted, dict()
    if name == "no_window_mass_replan":
        return perm, s_sorted, dict(max_chunks=4)
    if name == "repair_6000_copy_run":
        s = np.sort(np.concatenate([s_sorted, np.full(6000, 100, np.int32)]))
        return local_shuffle(N, 8, 7), s, dict(locality_window=8)
    if name == "switch_shuffled_declared_w16":
        return perm, s_sorted, dict(locality_window=16)
    raise KeyError(name)


CASES = ["presort", "presort_unique_narrow", "presort_duplicates",
         "presorted", "presorted_padded_duplicates",
         "presorted_heavy_run_mass_tagged", "sort_s_zipf_0.75",
         "sort_s_zipf_1.25", "sort_s_fk_locality_repair", "wide_bitonic_w600",
         "wide_blocks_w16", "wide_retry_oddeven", "no_window_duplicates",
         "no_window_mass_replan", "repair_6000_copy_run",
         "switch_shuffled_declared_w16"]


@pytest.mark.parametrize("name", CASES)
def test_plan_matches_jax(name):
    rkeys, skeys, kw = inputs(name)
    want = jpb.banded_join_pipelined(jnp.asarray(rkeys), jnp.asarray(skeys),
                                     tile=TILE, interpret=True, **kw)
    got = tpb.banded_join_pipelined(torch.from_numpy(rkeys),
                                    torch.from_numpy(skeys), tile=TILE, **kw)
    assert tuple(got) == tuple(want)
    assert all(type(x) is type(y) for x, y in zip(got, want))
    assert got.matches == numpy_matches(rkeys, skeys)
    assert got.output_sum == got.input_sum == int(rkeys.sum(dtype=np.int64))
    if name.startswith(("repair", "switch", "no_window_mass",
                        "presorted_heavy", "sort_s_fk")):
        assert got.overflow_tiles > 0
    if name.startswith(("switch", "no_window_mass", "presorted_heavy")):
        assert got.resorted and got.overflow_tiles > max(4, N // TILE // 8)
    if name == "switch_shuffled_declared_w16":
        assert got.violations > 0


def test_mass_replan_sorts_globally(monkeypatch):
    """The switch replans as sort-first: one global sort of R runs, after
    the retry's tiles all overflowed."""
    rkeys, skeys, kw = inputs("switch_shuffled_declared_w16")
    before = global_sort.LAUNCHES
    calls = []
    real = tpb.global_sort_tiles

    def spy(keys, *, tile):
        calls.append(keys.numel())
        return real(keys, tile=tile)

    monkeypatch.setattr(tpb, "global_sort_tiles", spy)
    out = tpb.banded_join_pipelined(torch.from_numpy(rkeys),
                                    torch.from_numpy(skeys), tile=TILE, **kw)
    assert calls == [N] and out.overflow_tiles == N // TILE
    assert global_sort.LAUNCHES == before        # CPU tensors: plain sort


@pytest.mark.parametrize("kw", [dict(presort=True, unique_both=True),
                                dict(locality_window=600, narrow=False),
                                dict(presorted=True),
                                dict(sort_s=True, presort=True)])
def test_enqueue_full_join_matches_jax(kw):
    """The fence-free bundle of any plan: the five scalars (matches,
    violations, flagged, out_sum, in_sum), the sorted build side and the
    band offsets against the JAX device chain."""
    rng = np.random.default_rng(23)
    n = N - 5
    rkeys = (local_shuffle(n, 600, 1) if "locality_window" in kw
             else rng.permutation(n).astype(np.int32) + 1)
    if kw.get("presorted"):
        rkeys = np.sort(rkeys)
    skeys = (rng.permutation(n).astype(np.int32) + 1 if kw.get("sort_s")
             else np.arange(1, n + 1, dtype=np.int32))
    want = jpb.enqueue_full_join(jnp.asarray(rkeys), jnp.asarray(skeys),
                                 tile=TILE, interpret=True, **kw)
    got = tpb.enqueue_full_join(torch.from_numpy(rkeys),
                                torch.from_numpy(skeys), tile=TILE, **kw)
    assert [int(x) for x in got[:5]] == [int(x) for x in want[:5]]
    np.testing.assert_array_equal(got[5].numpy(),
                                  np.asarray(want[5]).reshape(-1))
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(want[7]))
    np.testing.assert_array_equal(got[8].numpy() > 0,
                                  np.asarray(want[8]).reshape(-1) > 0)


def test_sort_probe_side_matches_jax():
    rng = np.random.default_rng(29)
    skeys = rng.integers(1, 3000, N - 300).astype(np.int32)
    j_sorted, j_s2d = jpb.sort_probe_side(jnp.asarray(skeys), TILE,
                                          interpret=True)
    t_sorted, t_s2d = tpb.sort_probe_side(torch.from_numpy(skeys), TILE)
    np.testing.assert_array_equal(t_sorted.numpy(), np.asarray(j_sorted))
    np.testing.assert_array_equal(t_s2d.numpy(), np.asarray(j_s2d).reshape(-1))


@pytest.mark.parametrize("n", [1, 2048, 2049, 6000, 16384])
def test_to_tiles_pow2_matches_jax(n):
    keys = np.arange(n, dtype=np.int32)
    np.testing.assert_array_equal(
        tpb.to_tiles_pow2(torch.from_numpy(keys), TILE).numpy(),
        np.asarray(jpb.to_tiles_2d_pow2(jnp.asarray(keys), TILE)).reshape(-1))
