"""The CUDA kernels (K1 fused sort + count, K2 tile sort, K3 global sort,
K4 general count, K5 narrow count) against their plain torch versions on
the card, exactly, and the join plans that run them.

Needs a CUDA device and nvcc; elsewhere every test skips.  The file imports
no jax, so it runs where jax is absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -m gpu -q

(``--noconftest``: the suite's conftest configures jax for the CPU.)
"""

import pytest
import torch

from htm_hashjoin_tpu_torch.data.generators import (local_shuffled_keys,
                                                    shuffled_keys,
                                                    sorted_keys, zipf_keys)
from htm_hashjoin_tpu_torch.joins import banded_backend as bb
from htm_hashjoin_tpu_torch.ops import banded_count as bc
from htm_hashjoin_tpu_torch.ops import banded_count_narrow as bcn
from htm_hashjoin_tpu_torch.ops import fused_sort_count as fsc
from htm_hashjoin_tpu_torch.ops import global_sort as gs
from htm_hashjoin_tpu_torch.ops import sort_tiles as st

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def k1_inputs(rkeys, skeys, tile):
    r_flat = bb.to_tiles(rkeys, tile)
    s_pad = bb.prepare_probe_side(skeys, tile)
    _, _, row_off, rows_needed = bb.band_rows(r_flat, skeys, tile)
    return r_flat, s_pad, row_off, rows_needed


@pytest.mark.parametrize("tile", fsc.KERNEL_TILES)
@pytest.mark.parametrize("method,passes,window", [
    ("blocks", 16, 16), ("blocks", 512, 512), ("oddeven", 4, 4),
    ("oddeven", 4, 64), ("bitonic", 1, 4096)])
def test_kernel_matches_plain(dev, tile, method, passes, window):
    n = 3 * tile - 77
    args = k1_inputs(local_shuffled_keys(n, window, tile, dev),
                     sorted_keys(n, dev), tile)
    kw = dict(tile=tile, method=method, passes=passes)
    before = fsc.LAUNCHES
    got = fsc.fused_sort_count(*args, **kw)
    torch.cuda.synchronize()
    assert fsc.LAUNCHES == before + 1
    want = fsc.fused_sort_count_ref(*args, **kw)
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        assert torch.equal(g, w)
    exact = want[1][:, 2] == 0
    assert torch.equal(got[2][exact], want[2][exact])


def test_band_past_probe_end_is_flagged_not_read(dev):
    tile = 8192
    keys = sorted_keys(2 * tile, dev)
    r_flat, s_pad, row_off, rows_needed = k1_inputs(keys, keys, tile)
    row_off[1] = s_pad.numel() // 128 - 8        # band would run past the end
    _, _, counts, flags = fsc.fused_sort_count(
        r_flat, s_pad, row_off, rows_needed, tile=tile, method="bitonic")
    assert flags.tolist() == [0, 2] and counts[1] == 0
    with pytest.raises(ValueError, match="prepare_probe_side"):
        bb.banded_join_pipelined(keys, keys, tile=tile, locality_window=16,
                                 s2d=s_pad[:2 * tile])


def test_join_on_the_card(dev):
    n = (1 << 20) + 77
    out = bb.banded_join_pipelined(local_shuffled_keys(n, 16, 0, dev),
                                   sorted_keys(n, dev), locality_window=16,
                                   unique_both=True)
    assert out.matches == n and not out.resorted
    assert out.output_sum == out.input_sum == n * (n + 1) // 2


def duplicates(n, dev, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randint(1, max(2, n // 7), (n,), generator=gen, device=dev,
                         dtype=torch.int32)


@pytest.mark.parametrize("tile", st.KERNEL_TILES)
@pytest.mark.parametrize("method,passes", [
    ("bitonic", 1), ("bitonic_alt", 1), ("blocks", 16), ("oddeven", 4)])
@pytest.mark.parametrize("kind", ["displaced", "duplicates"])
def test_k2_matches_plain(dev, tile, method, passes, kind):
    n = 3 * tile - 77
    keys = (local_shuffled_keys(n, 64, tile, dev) if kind == "displaced"
            else duplicates(n, dev))
    keys = bb.to_tiles(keys, tile)
    before = st.LAUNCHES
    got = st.sort_tiles(keys, tile=tile, method=method, passes=passes)
    torch.cuda.synchronize()
    assert st.LAUNCHES == before + 1
    want = st.sort_tiles_ref(keys, tile=tile, method=method, passes=passes)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [2048, 6000, 32768, 100_000, (1 << 20) + 5])
@pytest.mark.parametrize("kind", ["permutation", "duplicates"])
def test_k3_matches_plain(dev, n, kind):
    keys = (shuffled_keys(n, 1, dev) if kind == "permutation"
            else duplicates(n, dev, 2))
    padded = bb.to_tiles_pow2(keys, 2048)
    before = gs.LAUNCHES
    got = gs.global_sort_tiles(padded, tile=2048)
    torch.cuda.synchronize()
    assert gs.LAUNCHES == before + (padded.numel() > gs.GSORT_BLOCK)
    assert torch.equal(got, gs.global_sort_ref(padded))
    assert torch.equal(got[:n], torch.sort(keys).values)


def count_inputs(dev, tile, n_tiles=6):
    """Sorted tiles of duplicate keys, a sorted S with a heavy run, and
    chunk counts 0, 1 and many."""
    r = torch.sort(duplicates(n_tiles * tile - 300, dev, 3)).values
    s = torch.sort(torch.cat([duplicates(n_tiles * tile, dev, 4),
                              torch.full((3 * tile,), 5, dtype=torch.int32,
                                         device=dev)])).values
    r_flat = bb.to_tiles(r, tile)
    s_pad = bb.prepare_probe_side(s, tile)
    mins, maxs, _ = st.tile_stats(r_flat, tile)
    row_off, rows_needed = bb._rows(*bb._slice_offsets(s, mins, maxs))
    return r_flat, s_pad, row_off, rows_needed


@pytest.mark.parametrize("tile", bc.KERNEL_TILES)
def test_k4_matches_plain(dev, tile):
    r_flat, s_pad, row_off, rows_needed = count_inputs(dev, tile)
    n_chunks = bb._n_chunks(rows_needed, tile)
    n_chunks[1] = 0
    n_chunks[2] = 1
    assert int(n_chunks.max()) > 1
    before = bc.LAUNCHES
    got = bc.banded_count(r_flat, s_pad, row_off, n_chunks, tile=tile)
    torch.cuda.synchronize()
    assert bc.LAUNCHES == before + 1
    want = bc.banded_count_ref(r_flat, s_pad, row_off, n_chunks, tile=tile)
    assert torch.equal(got[0], want[0]) and not got[1].any()


def test_k4_heavy_hitter_2_to_the_37(dev):
    """One tile of 8192 copies of a key against 2^24 copies in S."""
    tile = 8192
    r = torch.full((tile,), 9, dtype=torch.int32, device=dev)
    s = torch.full((1 << 24,), 9, dtype=torch.int32, device=dev)
    s_pad = bb.prepare_probe_side(s, tile)
    n_chunks = torch.tensor([(1 << 24) // tile], dtype=torch.int32,
                            device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    counts, status = bc.banded_count(r, s_pad, zero, n_chunks, tile=tile)
    assert int(counts[0]) == 1 << 37 and int(status[0]) == 0


def test_k4_chunks_past_the_end_get_status_2(dev):
    tile = 8192
    keys = sorted_keys(2 * tile, dev)
    s_pad = bb.prepare_probe_side(keys, tile)
    n_chunks = torch.tensor([1, s_pad.numel() // tile + 1], dtype=torch.int32,
                            device=dev)
    counts, status = bc.banded_count(keys, s_pad,
                                     torch.zeros_like(n_chunks), n_chunks,
                                     tile=tile)
    assert status.tolist() == [0, 2] and int(counts[1]) == 0


@pytest.mark.parametrize("tile", bcn.KERNEL_TILES)
def test_k5_matches_plain_and_k1(dev, tile):
    args = count_inputs(dev, tile)
    before = bcn.LAUNCHES
    got = bcn.banded_count_narrow(*args, tile=tile)
    torch.cuda.synchronize()
    assert bcn.LAUNCHES == before + 1
    want = bcn.banded_count_narrow_ref(*args, tile=tile)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].max()) == 1                  # the heavy run's tiles
    k1 = fsc.fused_sort_count(*args, tile=tile, method="bitonic")
    assert torch.equal(k1[2], got[0]) and torch.equal(k1[3], got[1])


@pytest.mark.parametrize("kw", [
    dict(presort=True, unique_both=True), dict(presort=True),
    dict(locality_window=600, narrow=False), dict(locality_window=16)])
def test_plans_on_the_card(dev, kw):
    n = (1 << 20) + 77
    r = (local_shuffled_keys(n, 600, 0, dev) if "narrow" in kw
         else shuffled_keys(n, 0, dev))
    out = bb.banded_join_pipelined(r, sorted_keys(n, dev), **kw)
    assert out.matches == n
    assert out.output_sum == out.input_sum == n * (n + 1) // 2


def test_skewed_probe_and_builds_on_the_card(dev):
    n = 1 << 20
    s = zipf_keys(n, n, 1.25, 3, dev)
    out = bb.banded_join_pipelined(shuffled_keys(n, 2, dev), s, sort_s=True,
                                   presort=True)
    assert out.matches == n and out.overflow_tiles > 0
    build = bb.banded_build_pipelined(shuffled_keys(n, 4, dev))
    assert build.output_sum == build.input_sum == n * (n + 1) // 2
    heavy = torch.full((1 << 20,), 3, dtype=torch.int32, device=dev)
    assert int(bb.tagged_count(heavy, heavy, tile=8192)) == 1 << 40
