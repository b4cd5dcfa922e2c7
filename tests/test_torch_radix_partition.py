"""The port's multipass radix partition against the JAX package's
(``ops/pallas/radix_kernels.py``, the scatter kernel in interpret mode) on
the same numpy inputs, at tiles 1024 and 4096 (the shapes of
``tests/test_radix_multipass.py``): the pass plan, the per-tile digit
bounds, every ScatterPlan field, K6's plain version against the JAX
scatter bit for bit (the flat output against the (rows, 128) one), and the
whole partition at 2 and 3 passes.  Also the MSB partition and the int64
tagged probe of the sort route.  Tolerance 0: integer outputs.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from htm_hashjoin_tpu.ops import partition as jpart
from htm_hashjoin_tpu.ops import probe as jprobe
from htm_hashjoin_tpu.ops.pallas import radix_kernels as jrk
from htm_hashjoin_tpu_torch.constants import MAXI32
from htm_hashjoin_tpu_torch.ops import partition as tpart
from htm_hashjoin_tpu_torch.ops import probe as tprobe
from htm_hashjoin_tpu_torch.ops import radix_kernels as trk
from htm_hashjoin_tpu_torch.ops import scatter_tiles as sct


def permutation(n, seed):
    return np.random.default_rng(seed).permutation(
        np.arange(1, n + 1)).astype(np.int32)


def alphabet3(n, seed):
    return np.random.default_rng(seed).integers(1, 4, n).astype(np.int32)


def tile_sorted(keys, tile):
    """The MAXI32-padded keys with every tile sorted (what K2 "bitonic" and
    the JAX tile sort both give), flat."""
    pad = -len(keys) % tile
    flat = np.concatenate([keys, np.full(pad, MAXI32, np.int32)])
    return np.sort(flat.reshape(-1, tile), axis=1).reshape(-1)


@pytest.mark.parametrize("key_bits,radix_bits,passes", [
    (29, 14, 2), (29, 14, 1), (13, 4, 2), (13, 6, 3), (14, 6, 2), (6, 4, 2),
    (31, 14, 2), (28, 14, 2), (10, 20, 2), (5, 3, 4)])
def test_plan_passes_matches_jax(key_bits, radix_bits, passes):
    want = jrk.plan_passes(key_bits, radix_bits, passes)
    got = trk.plan_passes(key_bits, radix_bits, passes)
    assert [tuple(p) for p in got] == [tuple(p) for p in want]


# (name, keys, tile, fanout, shift, align, n_parents): pass 1 of the JAX
# tests' shapes, fanout 8 and 128, runs spanning several CH chunks, empty
# runs, and a tile-aligned pass under two parents
SCATTER_CASES = {
    "fanout8": (permutation(4096, 1), 1024, 8, 10, False, 1),
    "fanout128": (permutation(4096, 2), 1024, 128, 5, False, 1),
    "fanout128_aligned": (permutation(6000, 3), 1024, 128, 6, True, 1),
    "alphabet3_whole_tile_runs": (alphabet3(8192, 7), 4096, 4, 4, True, 1),
    "alphabet3_empty_runs": (alphabet3(8192, 8), 4096, 4, 0, False, 1),
    "two_parents": (np.sort(permutation(8192, 4)), 4096, 8, 9, False, 2),
}


@functools.lru_cache(maxsize=None)
def scatter_pair(name):
    """(JAX bounds, plan, output; port sorted keys, parent) of a case, the
    JAX scatter run once in interpret mode."""
    keys, tile, fanout, shift, align, n_parents = SCATTER_CASES[name]
    flat = tile_sorted(keys, tile)
    rpt = tile // 128
    n_tiles = len(flat) // tile
    parent = (np.arange(n_tiles) * n_parents // n_tiles).astype(np.int32)
    sorted2d = jnp.asarray(flat.reshape(-1, 128))
    bounds = jrk.tile_digit_bounds(sorted2d, fanout=fanout, shift=shift,
                                   rows_per_tile=rpt)
    plan = jrk.scatter_plan(bounds, jnp.asarray(parent), fanout=fanout,
                            rows_per_tile=rpt, align_tiles=align,
                            n_parents=n_parents)
    out = jrk.scatter_tiles(sorted2d, plan, rows_per_tile=rpt, fanout=fanout,
                            interpret=True)
    return (np.asarray(bounds), plan, np.asarray(out).reshape(-1),
            torch.from_numpy(flat), torch.from_numpy(parent))


def port_plan(name):
    keys, tile, fanout, shift, align, n_parents = SCATTER_CASES[name]
    _, _, _, flat, parent = scatter_pair(name)
    bounds = trk.tile_digit_bounds(flat, fanout=fanout, shift=shift,
                                   tile=tile)
    plan = trk.scatter_plan(bounds, parent, fanout=fanout,
                            rows_per_tile=tile // 128, align_tiles=align,
                            n_parents=n_parents)
    return bounds, plan


@pytest.mark.parametrize("name", list(SCATTER_CASES))
def test_digit_bounds_and_scatter_plan_match_jax(name):
    want_bounds, want, _, _, _ = scatter_pair(name)
    bounds, got = port_plan(name)
    assert bounds.dtype == torch.int32
    np.testing.assert_array_equal(bounds.numpy(), want_bounds)
    for field in trk.ScatterPlan._fields[:-1]:
        g = getattr(got, field)
        assert g.dtype == torch.int32, field
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert got.out_rows == want.out_rows


@pytest.mark.parametrize("name", list(SCATTER_CASES))
def test_scatter_plain_equals_jax_scatter_bit_for_bit(name):
    keys, tile, _, _, _, _ = SCATTER_CASES[name]
    _, _, want, flat, _ = scatter_pair(name)
    _, plan = port_plan(name)
    before = sct.LAUNCHES
    got = sct.scatter_tiles(flat, plan.a_elem, plan.dest_row, tile=tile,
                            out_rows=plan.out_rows)
    assert sct.LAUNCHES == before          # CPU tensors: the plain version
    assert got.dtype == torch.int32 and got.numel() == plan.out_rows * 128
    np.testing.assert_array_equal(got.numpy(), want)
    vals = want[want != MAXI32]
    np.testing.assert_array_equal(np.sort(vals), np.sort(keys))


def test_runs_span_several_chunks():
    """The alphabet {1..3} case holds whole-tile runs of 32 rows (two of
    the TPU kernel's CH-row chunks), and the other case empty runs."""
    _, plan = port_plan("alphabet3_whole_tile_runs")
    assert int(plan.n_chunks.max()) == 2 and int(plan.hist.max()) == 4096
    _, plan = port_plan("alphabet3_empty_runs")
    assert bool((plan.hist == 0).any()) and int(plan.n_chunks.max()) == 1


@pytest.mark.parametrize("n,bits,passes,key_bits,tile,kind", [
    (4096, 4, 2, 13, 1024, "permutation"),
    (8192, 6, 2, 14, 1024, "permutation"),
    (4096, 6, 3, 13, 1024, "permutation"),
    (8192, 4, 2, 6, 4096, "alphabet3"),
])
def test_multipass_partition_matches_jax(n, bits, passes, key_bits, tile,
                                         kind):
    keys = permutation(n, n + bits) if kind == "permutation" \
        else alphabet3(n, 7)
    want = jrk.multipass_radix_partition(jnp.asarray(keys), radix_bits=bits,
                                         passes=passes, key_bits=key_bits,
                                         tile=tile, interpret=True)
    got = trk.multipass_radix_partition(torch.from_numpy(keys),
                                        radix_bits=bits, passes=passes,
                                        key_bits=key_bits, tile=tile)
    assert [tuple(p) for p in got.pass_plans] == \
        [tuple(p) for p in want.pass_plans]
    assert len(got.pass_plans) == passes and got.n == want.n == n
    np.testing.assert_array_equal(got.partitioned.numpy(),
                                  np.asarray(want.partitioned2d).reshape(-1))
    assert len(got.pass_hists) == len(want.pass_hists)
    for g, w in zip(got.pass_hists, want.pass_hists):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_parents_from_regions_matches_jax():
    region_rows = np.array([8, 0, 0, 16, 8, 0, 24, 8], np.int32)
    n_tiles = int(region_rows.sum()) // 8
    want = jrk._parents_from_regions(jnp.asarray(region_rows),
                                     n_tiles=n_tiles, rows_per_tile=8)
    got = trk._parents_from_regions(torch.from_numpy(region_rows),
                                    n_tiles=n_tiles, rows_per_tile=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_plain_refuses_a_key_outside_the_output():
    _, plan = port_plan("fanout8")
    _, _, _, flat, _ = scatter_pair("fanout8")
    with pytest.raises(ValueError, match="outside"):
        sct.scatter_tiles(flat, plan.a_elem, plan.dest_row, tile=1024,
                          out_rows=plan.out_rows // 2)


@pytest.mark.parametrize("bad", ["fanout", "rows", "dtype", "tile",
                                 "out_rows", "1d"])
def test_scatter_bad_arguments_raise(bad):
    _, plan = port_plan("fanout8")
    _, _, _, flat, _ = scatter_pair("fanout8")
    a, d, tile, out_rows = plan.a_elem, plan.dest_row, 1024, plan.out_rows
    if bad == "fanout":
        a = d = torch.zeros((a.shape[0], 256), dtype=torch.int32)
    elif bad == "rows":
        a, d = a[1:].contiguous(), d[1:].contiguous()
    elif bad == "dtype":
        a = a.to(torch.int64)
    elif bad == "tile":
        tile = 1000
    elif bad == "out_rows":
        out_rows = -1
    elif bad == "1d":
        a = a.reshape(-1)
    with pytest.raises(ValueError):
        sct.scatter_tiles(flat, a, d, tile=tile, out_rows=out_rows)


# ---------------------------------------------------------------------------
# The sort route: MSB partition and the int64 tagged probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 4, 14])
@pytest.mark.parametrize("kind", ["permutation", "random31", "duplicates"])
def test_radix_partition_msb_matches_jax(bits, kind):
    rng = np.random.default_rng(bits)
    if kind == "permutation":
        keys = permutation(5000, 9)
    elif kind == "random31":
        keys = rng.integers(1, MAXI32, 5000).astype(np.int32)
    else:
        keys = rng.integers(1, 300, 5000).astype(np.int32)
    want, want_shift = jpart.radix_partition_msb(jnp.asarray(keys), bits)
    got, shift = tpart.radix_partition_msb(torch.from_numpy(keys), bits)
    assert int(shift) == int(want_shift)
    for field in ("keys", "digits", "hist", "offsets"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)


def test_bit_length_histogram_and_scan_match_jax():
    for v in (0, 1, 2, 3, 255, 256, 1 << 28, MAXI32):
        assert int(tpart.bit_length(torch.tensor(v, dtype=torch.int32))) \
            == int(jpart.bit_length(jnp.int32(v))) == v.bit_length()
    digits = np.random.default_rng(3).integers(0, 16, 999).astype(np.int32)
    hist = tpart.histogram(torch.from_numpy(digits), 16)
    np.testing.assert_array_equal(
        hist.numpy(), np.asarray(jpart.histogram(jnp.asarray(digits), 16)))
    np.testing.assert_array_equal(
        tpart.exclusive_scan(hist).numpy(),
        np.asarray(jpart.exclusive_scan(jnp.asarray(hist.numpy()))))


@pytest.mark.parametrize("kind", ["random31", "duplicates", "disjoint"])
def test_probe_sorted_matches_jax_on_full_range_keys(kind):
    """int64 composites: keys up to 2^31 - 2, where key*2+1 passes int32."""
    rng = np.random.default_rng(5)
    if kind == "random31":
        r = rng.integers(MAXI32 - 3000, MAXI32, 4000).astype(np.int32)
        s = np.concatenate([r[:1500], rng.integers(1, MAXI32, 2000)
                            ]).astype(np.int32)
    elif kind == "duplicates":
        r = rng.integers(1, 50, 3000).astype(np.int32)
        s = rng.integers(1, 60, 5000).astype(np.int32)
    else:
        r = np.arange(1, 1000, dtype=np.int32)
        s = np.arange(1000, 3000, dtype=np.int32)
    want = int(jprobe.probe_sorted(jnp.asarray(r), jnp.asarray(s)))
    got = tprobe.probe_sorted(torch.from_numpy(r), torch.from_numpy(s))
    assert got.dtype == torch.int64
    kr, cr = np.unique(r, return_counts=True)
    ks, cs = np.unique(s, return_counts=True)
    _, ir, i_s = np.intersect1d(kr, ks, return_indices=True)
    assert int(got) == want == int(np.sum(cr[ir].astype(np.int64) * cs[i_s]))


def test_all_padding_tiles_of_a_partition_count_nothing():
    """The partition's interspersed all-MAXI32 tiles (min MAXI32, max
    INT32_MIN) get empty bands, 0 chunks, and the probe counts exactly."""
    from htm_hashjoin_tpu_torch.joins import banded_backend as bb
    from htm_hashjoin_tpu_torch.ops.sort_tiles import sort_tiles
    tile = 2048
    keys = torch.from_numpy(permutation(8192, 12))
    part = trk.multipass_radix_partition(keys, radix_bits=6, passes=2,
                                         key_bits=14, tile=tile)
    sorted_flat, stats = sort_tiles(part.partitioned, tile=tile,
                                    method="bitonic")
    padding = (sorted_flat.view(-1, tile) == MAXI32).all(1)
    assert int(padding.sum()) > 0 and not bool(padding.all())
    build = bb.BandedBuild(sorted_flat, stats[:, 0], stats[:, 1], tile,
                           part.n, 0, False)
    s = torch.arange(1, 8193, dtype=torch.int32)
    _, rows_needed = bb._rows(*bb._slice_offsets(s, build.mins, build.maxs))
    assert not bool(rows_needed[padding].any())
    assert bb.banded_probe(build, s) == (8192, 0)
