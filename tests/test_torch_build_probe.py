"""The port's build-only pipeline, probe of a build artifact and tagged count
against the JAX package's (Pallas kernels in interpret mode) on the same
numpy inputs, tile 2048, N = 2^14.  Tolerance 0: integer outputs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from htm_hashjoin_tpu.joins import pallas_backend as jpb
from htm_hashjoin_tpu.ops.pallas import join_kernels as jk
from htm_hashjoin_tpu_torch.constants import MAXI32
from htm_hashjoin_tpu_torch.joins import banded_backend as tpb
from htm_hashjoin_tpu_torch.relation import banded_build_from_numpy

TILE = 2048
N = 1 << 14


def local_shuffle(n, window, seed):
    """1..n, each key moved less than `window` places (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    return (np.argsort(np.arange(n) + rng.integers(0, window, n),
                       kind="stable") + 1).astype(np.int32)


def numpy_matches(r, s):
    kr, cr = np.unique(r, return_counts=True)
    ks, cs = np.unique(s, return_counts=True)
    _, ir, i_s = np.intersect1d(kr, ks, return_indices=True)
    return int(np.sum(cr[ir].astype(np.int64) * cs[i_s]))


def build_input(name):
    rng = np.random.default_rng(31)
    dup = rng.integers(1, N // 8, N - 77).astype(np.int32)
    if name == "locality_w16":
        return local_shuffle(N, 16, 1), dict(locality_window=16)
    if name == "retry_w64_as_w4":
        return local_shuffle(N, 64, 0), dict(locality_window=4)
    if name == "retry_duplicates":
        keys = np.sort(dup)[local_shuffle(dup.size, 64, 2) - 1]
        return keys, dict(locality_window=16)
    if name == "no_locality":
        return (rng.permutation(N) + 1).astype(np.int32), dict()
    if name == "presort":
        return dup, dict(presort=True)
    if name == "presorted":
        return np.sort(dup), dict(presorted=True)
    raise KeyError(name)


BUILDS = ["locality_w16", "retry_w64_as_w4", "retry_duplicates",
          "no_locality", "presort", "presorted"]


def jax_retry_outcome(rkeys, window, track):
    """What the JAX banded_build_pipelined returns after an abort, from its
    own parts: the optimistic sort's per-tile violations, then the bitonic
    retry's output sum and duplicate aliases.  (The JAX function itself
    raises on that path with numpy 2: it writes into the read-only array
    np.asarray gives for a jax array.)"""
    r2d = jpb.to_tiles_2d(jnp.asarray(rkeys), TILE)
    method, passes = jpb._sort_method(window, TILE)
    _, stats = jk.sort_tiles(r2d, tile=TILE, method=method, passes=passes,
                             interpret=True)
    exact, _ = jk.sort_tiles(r2d, tile=TILE, method="bitonic", interpret=True)
    viols = np.asarray(stats[:, 2], np.int64)
    out = jpb.BandedJoinOutcome(
        0, int(viols.sum()), 0, int(jpb._sum_i64(jnp.where(
            exact == MAXI32, 0, exact))), True,
        int(jpb._sum_i64(jnp.where(r2d == MAXI32, 0, r2d))))
    if track:
        return out, viols, np.asarray(jpb._tile_dup_counts(exact, TILE // 128))
    return out


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("name", BUILDS)
def test_build_pipeline_matches_jax(name, track):
    rkeys, kw = build_input(name)
    if name.startswith("retry"):
        want = jax_retry_outcome(rkeys, kw["locality_window"], track)
    else:
        want = jpb.banded_build_pipelined(jnp.asarray(rkeys), tile=TILE,
                                          return_tile_violations=track,
                                          interpret=True, **kw)
    got = tpb.banded_build_pipelined(torch.from_numpy(rkeys), tile=TILE,
                                     return_tile_violations=track, **kw)
    if track:
        (want, j_viols, j_dups), (got, viols, dups) = want, got
        np.testing.assert_array_equal(viols.numpy(), j_viols)
        np.testing.assert_array_equal(dups.numpy(), j_dups)
        assert viols.dtype == dups.dtype == torch.int64
    assert tuple(got) == tuple(want)
    assert all(type(x) is type(y) for x, y in zip(got, want))
    assert got.output_sum == got.input_sum == int(rkeys.sum(dtype=np.int64))
    assert got.resorted == name.startswith("retry")


@pytest.mark.parametrize("kw", [dict(locality_window=4), dict(presort=True),
                                dict(presorted=True), dict()])
def test_enqueue_build_head_matches_jax(kw):
    rkeys = local_shuffle(N - 5, 64, 4)
    if kw.get("presorted"):
        rkeys = np.sort(rkeys)
    want = jpb.enqueue_banded_build(jnp.asarray(rkeys), tile=TILE,
                                    interpret=True, **kw)
    got = tpb.enqueue_banded_build(torch.from_numpy(rkeys), tile=TILE, **kw)
    assert got.tolist() == np.asarray(want).tolist()


def jax_build(rkeys, **kw):
    return jpb.banded_build(jnp.asarray(rkeys), tile=TILE, interpret=True,
                            **kw)


@pytest.mark.parametrize("max_chunks", [4, 16])
def test_probe_of_a_jax_built_artifact_matches_jax(max_chunks):
    """Window-1500 data on the exact bitonic build: bands of up to about
    two chunks, so max_chunks 4 leaves a few overflow tiles to repair in
    one batch and 16 none."""
    rng = np.random.default_rng(37)
    rkeys = local_shuffle(N, 1500, 5)
    rkeys[:3000] = rng.integers(1, 40, 3000)        # a few wide tiles
    skeys = np.sort(np.concatenate([np.arange(1, N + 1, dtype=np.int32),
                                    np.full(9000, 20, np.int32)]))
    build = jax_build(rkeys)
    want = jpb.banded_probe(build, jnp.asarray(skeys), max_chunks=max_chunks,
                            interpret=True)
    got = tpb.banded_probe(banded_build_from_numpy(build),
                           torch.from_numpy(skeys), max_chunks=max_chunks)
    assert got == want
    assert got[0] == numpy_matches(rkeys, skeys)
    assert (got[1] > 0) == (max_chunks == 4)


def test_probe_mass_overflow_counts_only_the_bad_tiles():
    """5 of 8 tiles overflow under max_chunks=4: more than max(4, 8/8), so
    the repair takes its mass branch.  The JAX function counts the WHOLE
    build there and adds it to the 3 good tiles' matches (ADVICE r5 #1);
    the port counts only the 5 bad tiles and gives the exact count."""
    rng = np.random.default_rng(41)
    good = np.arange(1, 3 * TILE + 1, dtype=np.int32)      # 3 narrow tiles
    wide = (rng.permutation(N - 3 * TILE) + 3 * TILE + 1).astype(np.int32)
    rkeys = np.concatenate([good, wide])
    skeys = np.arange(1, N + 1, dtype=np.int32)
    build = jax_build(rkeys)
    j_matches, j_overflow = jpb.banded_probe(build, jnp.asarray(skeys),
                                             max_chunks=4, interpret=True)
    matches, overflow = tpb.banded_probe(banded_build_from_numpy(build),
                                         torch.from_numpy(skeys),
                                         max_chunks=4)
    assert overflow == j_overflow == 5
    assert matches == numpy_matches(rkeys, skeys) == N
    assert j_matches == N + good.size              # the reference's double count


def test_build_from_sorted_matches_jax():
    keys = np.sort(np.random.default_rng(43).integers(1, 900, N - 100)
                   .astype(np.int32))
    want = jpb.banded_build_from_sorted(jnp.asarray(keys), tile=TILE)
    got = tpb.banded_build_from_sorted(torch.from_numpy(keys), tile=TILE)
    same = banded_build_from_numpy(want)
    for a, b in zip(got, same):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b and type(a) is type(b)


def test_tagged_count_matches_jax_with_padding():
    rng = np.random.default_rng(47)
    r = rng.integers(1, N // 16, N).astype(np.int32)
    s = np.sort(rng.integers(1, N // 16, N).astype(np.int32))
    want = int(jpb.tagged_count(jnp.asarray(r), jnp.asarray(s), tile=TILE,
                                interpret=True))
    r_pad = np.concatenate([r, np.full(37, MAXI32, np.int32)])
    got = tpb.tagged_count(torch.from_numpy(r_pad), torch.from_numpy(s),
                           tile=TILE)
    assert int(got) == want == numpy_matches(r, s)


def test_tagged_count_heavy_hitter_past_32_bits():
    """2^16 copies of one key each side: 2^32 pairs through the plain K3
    and the int64 segmented count."""
    keys = torch.full((1 << 16,), 3, dtype=torch.int32)
    assert int(tpb.tagged_count(keys, keys, tile=TILE)) == 1 << 32


def test_segmented_count_matches_jax():
    """The count over a sorted key*2+tag stream (two binary searches per
    element here, a cumsum and a cummax in JAX), padding included."""
    rng = np.random.default_rng(53)
    r = rng.integers(1, 300, 5000).astype(np.int32) * 2
    s = rng.integers(1, 300, 7000).astype(np.int32) * 2 + 1
    comp = np.sort(np.concatenate([r, s, np.full(100, MAXI32, np.int32)]))
    want = int(jpb._segmented_count_tagged(jnp.asarray(comp)))
    got = tpb._segmented_count_tagged(torch.from_numpy(comp))
    assert int(got) == want == numpy_matches(r // 2, s // 2)
