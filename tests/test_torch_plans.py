"""Every plan of the port's banded_join_pipelined against the JAX package's
(Pallas kernels in interpret mode) on the same numpy inputs, at tile 2048
and N = 2^14: sort-first (presort), presorted, unsorted probe side
(sort_s, zipf S), wide band (narrow=False), no locality window, the
flagged-tile repair, the mass-overflow replan and, on sorted plans, the
in-place recount of a mass of flagged tiles.

Each field of the outcome must agree exactly (matches, violations, overflow
tiles, both key sums, whether a retry or replan ran), and the match count
must equal an exact numpy count.  Tolerance 0: integer outputs.
"""

import contextlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from htm_hashjoin_tpu.joins import pallas_backend as jpb
from htm_hashjoin_tpu_torch.joins import banded_backend as tpb
from htm_hashjoin_tpu_torch.ops import global_sort
from htm_hashjoin_tpu_torch.utils import timing

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


def piled_zipf_s(n, alphabet, theta, seed):
    """Zipf(theta) draws over a permuted alphabet 1..alphabet, unsorted:
    all of S falls in the bands of the R tiles that hold those keys."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, alphabet + 1) ** theta
    ranks = rng.choice(alphabet, n, p=p / p.sum())
    return (rng.permutation(alphabet)[ranks] + 1).astype(np.int32)


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
    if name == "presort_zipf_piled_mass":
        # Zipf(1.0) S piled on the keys of R's first six tiles
        return perm, piled_zipf_s(4 * N, 6 * TILE, 1.0, 6), dict(
            presort=True, sort_s=True, max_chunks=2)
    if name == "presort_narrow_piled_mass":
        # as above, counted first by the narrow count, which flags
        return perm, piled_zipf_s(4 * N, 6 * TILE, 1.0, 8), dict(
            presort=True, sort_s=True, narrow=True, max_chunks=2)
    if name == "presort_duplicates_across_flagged_tiles":
        # six R keys in runs of 2731 copies, each across a tile border;
        # S holds 3000 copies of each, and of 0 and 7, which R lacks
        dup_r = np.repeat(np.arange(1, 7, dtype=np.int32), 2731)[:N]
        dup_s = np.repeat(np.arange(0, 8, dtype=np.int32), 3000)
        return (rng.permutation(dup_r), rng.permutation(dup_s),
                dict(presort=True, sort_s=True, max_chunks=1))
    if name == "presort_s_keys_absent_from_r":
        # R the even keys 2..2N; S drawn over both parities of the first
        # six tiles' range and past R's largest key
        s_piled = np.concatenate([rng.integers(1, 12 * TILE, 4 * N),
                                  rng.integers(2 * N + 1, 3 * N, 100)])
        return (2 * perm, s_piled.astype(np.int32),
                dict(presort=True, sort_s=True, max_chunks=2))
    if name == "presorted_one_key_heavy_hitter":
        # one key in every row of R and S: all eight tiles hold that key
        # alone and each band is all of S
        heavy = np.full(N, 5, np.int32)
        return heavy, heavy, dict(presorted=True, max_chunks=2)
    if name == "presorted_one_key_tiles_flagged_and_not":
        # five tiles of key 7, whose band of 10240 S keys flags, then two
        # of key 9, whose band of one S key does not
        keys = np.concatenate([np.full(5 * TILE, 7), np.full(2 * TILE, 9),
                               np.arange(10, TILE + 10)]).astype(np.int32)
        s = np.concatenate([np.full(5 * TILE, 7), [9],
                            np.arange(10, TILE + 10)]).astype(np.int32)
        return keys, s, dict(presorted=True, max_chunks=2)
    if name == "presorted_padded_last_tile_mass":
        # R sorted and 77 keys short of N (MAXI32 in its last tile); S
        # piled on the keys of R's last five tiles
        s_piled = np.sort(rng.integers(3 * TILE + 1, N - 76, 4 * N))
        return (s_sorted[:N - 77].copy(), s_piled.astype(np.int32),
                dict(presorted=True, max_chunks=2))
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


# sorted plans whose count flags more than max(4, F/8) tiles
MASS_CASES = ["presort_zipf_piled_mass", "presort_narrow_piled_mass",
              "presort_duplicates_across_flagged_tiles",
              "presort_s_keys_absent_from_r",
              "presorted_padded_last_tile_mass",
              "presorted_one_key_heavy_hitter",
              "presorted_one_key_tiles_flagged_and_not"]
CASES = ["presort", "presort_unique_narrow", "presort_duplicates",
         "presorted", "presorted_padded_duplicates",
         "presorted_heavy_run_mass_tagged", "sort_s_zipf_0.75",
         "sort_s_zipf_1.25", "sort_s_fk_locality_repair", "wide_bitonic_w600",
         "wide_blocks_w16", "wide_retry_oddeven", "no_window_duplicates",
         "no_window_mass_replan", "repair_6000_copy_run",
         "switch_shuffled_declared_w16"] + MASS_CASES


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
    mass = name in MASS_CASES or name.startswith(
        ("switch", "no_window_mass", "presorted_heavy"))
    if mass or name.startswith(("repair", "sort_s_fk")):
        assert got.overflow_tiles > 0
    if mass:
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


@pytest.mark.parametrize("name", ["presorted_heavy_run_mass_tagged"]
                         + MASS_CASES)
def test_mass_overflow_recounts_flagged_tiles_in_place(name, monkeypatch):
    """On a sorted plan, mass overflow recounts the flagged tiles inside
    ``hj.recount`` with one more K4 count over the whole bands of those of
    more than one key, and those of one key from their bands' ends: the
    first count gave every flagged tile 0, the recount's K4 work is linear
    in S (at most two bands of tiles of more than one key hold an S key),
    K3 sorts no key beyond R and S, and the join reads back twice."""
    rkeys, skeys, kw = inputs(name)
    stack, counts, device_res = [], [], []

    @contextlib.contextmanager
    def span(label):
        stack.append(label)
        try:
            yield
        finally:
            stack.pop()

    def spy(fn, kernel):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            counts.append((kernel, tuple(stack), args[3], out))
            return out
        return call

    def join_device(*args, **kwargs):
        device_res.append(real_device(*args, **kwargs))
        return device_res[-1]

    real_device = tpb._banded_join_device
    monkeypatch.setattr(tpb, "span", span)
    monkeypatch.setattr(tpb, "banded_count", spy(tpb.banded_count, "K4"))
    monkeypatch.setattr(tpb, "banded_count_narrow",
                        spy(tpb.banded_count_narrow, "K5"))
    monkeypatch.setattr(tpb, "_banded_join_device", join_device)
    sorted_before, readbacks_before = (global_sort.SORTED_KEYS,
                                       timing.READBACKS)
    got = tpb.banded_join_pipelined(torch.from_numpy(rkeys),
                                    torch.from_numpy(skeys), tile=TILE, **kw)

    (res,) = device_res
    flagged = res[8] > 0
    tiles = res[5].view(-1, TILE)
    one_key = flagged & (tiles[:, 0] == tiles[:, -1])
    assert got.resorted and int(flagged.sum()) == got.overflow_tiles > 4
    first, recount = counts
    assert first[0] == ("K5" if kw.get("narrow") else "K4")
    assert "hj.recount" not in first[1]
    assert recount[0] == "K4" and recount[1][-2:] == ("hj.recount",
                                                      "hj.enqueue")
    assert not first[3][0][flagged].any()            # flagged tiles gave 0
    # K4 recounts the flagged tiles of more than one key, and no other
    assert torch.equal(recount[2] > 0, flagged & ~one_key)
    assert not recount[3][0][~flagged | one_key].any()
    assert int(recount[2].sum()) <= (2 * -(-skeys.size // TILE)
                                     + 2 * int((recount[2] > 0).sum()))
    from_ends = sum(numpy_matches(tiles[t].numpy(), skeys)
                    for t in torch.nonzero(one_key).reshape(-1).tolist())
    assert (int(first[3][0].sum()) + int(recount[3][0].sum()) + from_ends
            == got.matches == numpy_matches(rkeys, skeys))
    if name.startswith(("presorted_heavy", "presorted_one_key",
                        "presort_duplicates")):
        assert one_key.any()
    if name == "presorted_one_key_tiles_flagged_and_not":
        assert int(one_key.sum()) == 5 and not flagged[5:7].any()
    n_r = tpb.to_tiles_pow2(torch.from_numpy(rkeys), TILE).numel()
    n_s = tpb.to_tiles_pow2(torch.from_numpy(skeys), TILE).numel()
    assert global_sort.SORTED_KEYS - sorted_before == (
        kw.get("presort", False) * n_r + kw.get("sort_s", False) * n_s)
    assert timing.READBACKS - readbacks_before == 2
