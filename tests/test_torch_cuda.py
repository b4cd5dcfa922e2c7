"""The CUDA kernels (K1 fused sort + count and its band prepass, K2 tile
sort, K3 global sort, K4 general count, K5 narrow count, K6 radix scatter,
K7 key-value global sort) against their plain torch versions on the card,
exactly, the join
plans that run them, the multipass radix join, one CLI run per path the
planner chooses, and each scatter build's join (nocc, atomic, htm, npo,
npo_st; sortmerge's plain route) with the card's line equal to the CPU's;
the scatter tables' claim rounds and probe against theirs, K7a (the TPU's
kv phase A) bit for bit at every kernel tile in both directions, the Wisconsin kv split and three multijoin confs at a cut
scale, and the distributed join's four configurations (eight shards on the
card) with the card's line equal to the CPU's.

Needs a CUDA device and nvcc; elsewhere every test skips.  The file imports
no jax, so it runs where jax is absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -m gpu -q

(``--noconftest``: the suite's conftest configures jax for the CPU.)
"""

import dataclasses
import json

import pytest
import torch

from htm_hashjoin_tpu_torch import cli
from htm_hashjoin_tpu_torch.config import Algo, Distribution, JoinConfig
from htm_hashjoin_tpu_torch.constants import MAXI32
from htm_hashjoin_tpu_torch.data.generators import (build_relations,
                                                    local_shuffled_keys,
                                                    shuffled_keys,
                                                    sorted_keys, zipf_keys)
from htm_hashjoin_tpu_torch.joins import DISPATCH
from htm_hashjoin_tpu_torch.joins import banded_backend as bb
from htm_hashjoin_tpu_torch.joins.radix import radix_join
from htm_hashjoin_tpu_torch.ops import _build
from htm_hashjoin_tpu_torch.ops import banded_count as bc
from htm_hashjoin_tpu_torch.ops import banded_count_narrow as bcn
from htm_hashjoin_tpu_torch.ops import fused_sort_count as fsc
from htm_hashjoin_tpu_torch.ops import global_sort as gs
from htm_hashjoin_tpu_torch.ops import global_sort_kv as gkv
from htm_hashjoin_tpu_torch.ops import hashing, insert, probe
from htm_hashjoin_tpu_torch.ops import radix_kernels as rk
from htm_hashjoin_tpu_torch.ops import radix_sort as rs
from htm_hashjoin_tpu_torch.ops import scatter_tiles as sct
from htm_hashjoin_tpu_torch.ops import sort_kv_tiles as skv
from htm_hashjoin_tpu_torch.ops import sort_tiles as st
from htm_hashjoin_tpu_torch.ops import tile_minmax as tmm
from htm_hashjoin_tpu_torch.relation import Relation

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
    assert_k1_equal(got, want)


def assert_k1_equal(got, want):
    """K1 against its plain version: sorted tiles, stats, flags and both
    key sums bit for bit; counts on the tiles left without inversions."""
    for k in (0, 1, 3, 4, 5):
        assert torch.equal(got[k], want[k]), k
    exact = want[1][:, 2] == 0
    assert torch.equal(got[2][exact], want[2][exact])


K1_KINDS = ["duplicate runs", "run in the overhang", "pack limit",
            "negatives and INT32_MIN", "all MAXI32 tile",
            "oddeven too few passes", "6000-copy S run"]


def k1_kind(kind, tile, dev):
    """(unsorted R, sorted S, method, passes) of 4 tiles, each kind an edge
    of the register count: runs straddling a thread's E keys and a warp's
    32E; a run among a tile's last OV keys whose S copies straddle band
    position T (256 extra S keys a tile keep the bands row-aligned); keys at
    PACK_LIMIT and above; negatives with INT32_MIN; a tile of MAXI32 only;
    an odd-even sort with too few passes (inversions left); an S run of
    6000 copies that flags its tile."""
    n = 4 * tile
    gen = torch.Generator(device=dev)
    gen.manual_seed(tile)
    keys = torch.arange(1, n + 1, dtype=torch.int32, device=dev)

    def shuffle(x, window):   # each key moved less than window places
        jitter = torch.randint(0, window, (x.numel(),), generator=gen,
                               device=dev)
        order = torch.sort(torch.arange(x.numel(), device=dev) + jitter,
                           stable=True).indices
        return x[order]

    if kind == "duplicate runs":
        r = torch.repeat_interleave(keys, torch.randint(
            1, 12, (n,), generator=gen, device=dev))[:n].clone()
        warp_keys = 32 * (tile // 512 if tile <= 8192 else 16)
        r[warp_keys - 150:warp_keys + 150] = r[warp_keys - 150]
        s = torch.sort(torch.cat([torch.arange(1, int(r.max()) + 1,
                                               dtype=torch.int32, device=dev),
                                  r[::3]])).values
        return shuffle(r, 8), s, "blocks", 8
    if kind == "run in the overhang":
        r, extra = keys.clone(), []
        for t in range(4):
            k = int(r[t * tile + tile - 100])
            r[t * tile + tile - 110:t * tile + tile - 90] = k
            extra.append(torch.full((256,), k, dtype=torch.int32, device=dev))
        s = torch.sort(torch.cat([keys] + extra)).values
        return shuffle(r, 16), s, "blocks", 16
    if kind == "pack limit":
        high = torch.cat([(1 << 29) + torch.arange(400, device=dev),
                          torch.full((100,), MAXI32 - 1, device=dev)]).int()
        r = torch.sort(torch.cat([keys[:n - 500], high])).values
        s = torch.sort(torch.cat([r, high])).values
        return shuffle(r, 4), s, "oddeven", 4
    if kind == "negatives and INT32_MIN":
        r = torch.sort(torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                                     device=dev, dtype=torch.int32)).values
        r[:50] = -2**31
        s = torch.sort(torch.cat([r[::2], torch.full(
            (30,), -2**31, dtype=torch.int32, device=dev)])).values
        return shuffle(r, 512), s, "bitonic", 1
    if kind == "all MAXI32 tile":
        r = shuffle(keys, 16)
        r[tile:2 * tile] = MAXI32
        return r, keys, "blocks", 16
    if kind == "oddeven too few passes":
        return shuffle(keys, 64), keys, "oddeven", 1
    s = torch.sort(torch.cat([keys, torch.full((6000,), 100,
                                               dtype=torch.int32,
                                               device=dev)])).values
    return shuffle(keys, 8), s, "oddeven", 8


@pytest.mark.parametrize("tile", fsc.KERNEL_TILES)
@pytest.mark.parametrize("kind", K1_KINDS)
def test_k1_and_k5_edge_kinds_match_plain(dev, tile, kind):
    """K1 on the kind's unsorted tiles, then K5 on the same tiles sorted,
    each against its plain version."""
    rkeys, skeys, method, passes = k1_kind(kind, tile, dev)
    args = k1_inputs(rkeys, skeys, tile)
    kw = dict(tile=tile, method=method, passes=passes)
    got = fsc.fused_sort_count(*args, **kw)
    torch.cuda.synchronize()
    want = fsc.fused_sort_count_ref(*args, **kw)
    assert_k1_equal(got, want)
    viols = int(want[1][:, 2].sum())
    assert (viols > 0) == (kind == "oddeven too few passes")
    if kind == "6000-copy S run":
        assert int(want[3][0]) == 1
    if kind == "all MAXI32 tile":
        assert got[1][1].tolist() == [MAXI32, -2**31, 0]
        assert int(got[2][1]) == 0 and int(got[5][1]) == 0
    sorted_r = torch.sort(args[0].view(-1, tile), dim=1).values.reshape(-1)
    k5_args = (sorted_r,) + args[1:]
    got5 = bcn.banded_count_narrow(*k5_args, tile=tile)
    torch.cuda.synchronize()
    want5 = bcn.banded_count_narrow_ref(*k5_args, tile=tile)
    for g, w in zip(got5, want5):
        assert torch.equal(g, w)
    assert torch.equal(got5[2], want[4])


@pytest.mark.parametrize("tile", [2048, 8192, 16384])
@pytest.mark.parametrize("kind", ["padded", "padding tile", "negatives",
                                  "one tile"])
def test_tile_minmax_matches_plain(dev, tile, kind):
    n = (1 if kind == "one tile" else 5) * tile
    keys = sort_keys_of("negatives and INT32_MIN", n, dev, 6)
    if kind == "padded":
        keys = bb.to_tiles(keys[:n - 777], tile)
    elif kind == "padding tile":
        keys[tile:2 * tile] = MAXI32
        keys[-1] = MAXI32
    before = tmm.LAUNCHES
    got = tmm.tile_minmax(keys, tile)
    torch.cuda.synchronize()
    assert tmm.LAUNCHES == before + 1
    want = tmm.tile_minmax_ref(keys, tile)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if kind == "padding tile":
        assert got[0][1] == MAXI32 and got[1][1] == -2**31


def test_band_past_probe_end_is_flagged_not_read(dev):
    tile = 8192
    keys = sorted_keys(2 * tile, dev)
    r_flat, s_pad, row_off, rows_needed = k1_inputs(keys, keys, tile)
    row_off[1] = s_pad.numel() // 128 - 8        # band would run past the end
    _, _, counts, flags, in_sums, _ = fsc.fused_sort_count(
        r_flat, s_pad, row_off, rows_needed, tile=tile, method="bitonic")
    assert flags.tolist() == [0, 2] and counts[1] == 0
    assert int(in_sums.sum()) == 2 * tile * (2 * tile + 1) // 2
    counts, flags, _ = bcn.banded_count_narrow(r_flat, s_pad, row_off,
                                               rows_needed, tile=tile)
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
    ("bitonic", 1), ("bitonic_alt", 1), ("blocks", 16), ("oddeven", 4),
    ("blocks", 1), ("blocks", 600), ("oddeven", 1)])
@pytest.mark.parametrize("kind", ["displaced", "duplicates",
                                  "negatives and INT32_MIN", "padding"])
def test_k2_matches_plain(dev, tile, method, passes, kind):
    """The register-resident tile sort, bit for bit: blocks of 2, 32 and
    2048 keys (shifted by 1, 16 and 1024), one and four odd-even rounds;
    the last tile padded, and with "padding" a tile of MAXI32 only."""
    n = 3 * tile - 77
    if kind == "displaced":
        keys = local_shuffled_keys(n, 64, tile, dev)
    elif kind == "duplicates":
        keys = duplicates(n, dev)
    elif kind == "padding":
        keys = local_shuffled_keys(n, 64, tile, dev)
        keys[tile:2 * tile] = MAXI32
    else:
        keys = sort_keys_of(kind, n, dev, 3)
    keys = bb.to_tiles(keys, tile)
    before = st.LAUNCHES
    got = st.sort_tiles(keys, tile=tile, method=method, passes=passes)
    torch.cuda.synchronize()
    assert st.LAUNCHES == before + 1
    want = st.sort_tiles_ref(keys, tile=tile, method=method, passes=passes)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if kind == "padding":
        assert got[1][1].tolist() == [MAXI32, -2**31, 0]


SORT_KINDS = ["permutation", "duplicates", "negatives and INT32_MIN",
              "all equal", "two values", "16 copies a key",
              "rotation-packed"]


def sort_keys_of(kind, n, dev, seed=0):
    """Keys for the K3 and K7 tests: the edge cases of an LSD radix sort
    (sign flip, constant and skewed digits, the split's packed keys)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if kind == "permutation":
        return shuffled_keys(n, seed + 1, dev)
    if kind == "duplicates":
        return duplicates(n, dev, seed + 2)
    if kind == "negatives and INT32_MIN":
        keys = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             device=dev, dtype=torch.int32)
        keys[::97] = -2**31
        keys[1::89] = MAXI32
        return keys
    if kind == "all equal":
        return torch.full((n,), -7, dtype=torch.int32, device=dev)
    if kind == "two values":
        return torch.where(torch.rand(n, generator=gen, device=dev) < 0.5,
                           3, -5).to(torch.int32)
    if kind == "16 copies a key":
        return torch.randint(0, max(1, n // 16), (n,), generator=gen,
                             device=dev, dtype=torch.int32)
    from htm_hashjoin_tpu_torch.wisconsin import partitioner as wpart
    keys = torch.randint(1, 1 << 24, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    shard = (torch.arange(n, device=dev, dtype=torch.int32) // 4096) % 8
    return wpart._rot_pack(keys, shard, 1, 17, 6, 19, 3, n)


@pytest.mark.parametrize("n", [2048, 6000, 32768, 100_000, (1 << 20) + 5])
@pytest.mark.parametrize("kind", SORT_KINDS)
def test_k3_matches_plain(dev, n, kind):
    keys = sort_keys_of(kind, n, dev)
    padded = bb.to_tiles_pow2(keys, 2048)
    before = gs.LAUNCHES
    got = gs.global_sort_tiles(padded, tile=2048)
    torch.cuda.synchronize()
    assert gs.LAUNCHES == before + 1
    assert torch.equal(got, gs.global_sort_ref(padded))
    assert torch.equal(got[:n], torch.sort(keys).values)


@pytest.mark.parametrize("n", [1, 3, 6143, 6145, 12345, (1 << 20) + 77])
def test_radix_sort_takes_any_length(dev, n):
    """The kernel masks a ragged last tile; values follow stably."""
    keys = duplicates(n, dev, 9) - n // 14
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    assert torch.equal(rs.sort_keys("test", keys),
                       torch.sort(keys, stable=True).values)
    got_k, got_v = rs.sort_pairs("test", keys, vals)
    want_k, order = torch.sort(keys, stable=True)
    assert torch.equal(got_k, want_k) and torch.equal(got_v, order.int())


def test_radix_scratch_follows_the_model_tile(dev):
    """The histogram and one tile counter a pass (an even count of 32-bit
    words), then a 64-bit look-back status word per (pass, tile, digit)."""
    lib = _build.load_library()
    head = rs.PASSES * rs.BINS + rs.PASSES
    assert head % 2 == 0
    for n in (1, rs.TILE_KEYS, rs.TILE_KEYS + 1, 1 << 20, 1 << 30):
        tiles = -(-n // rs.TILE_KEYS)
        assert lib.htm_radix_sort_scratch_words(n) == \
            head + 2 * rs.PASSES * tiles * rs.BINS


def test_k3_sorts_2_to_the_29_plus_1(dev):
    """Past the old 2^30-key cap: 2^29 + 1 keys padded to 2^30 (about
    12 GiB with the plain version), exactly."""
    keys = sort_keys_of("negatives and INT32_MIN", (1 << 29) + 1, dev, 11)
    padded = bb.to_tiles_pow2(keys, 8192)
    del keys
    assert padded.numel() == 1 << 30
    got = gs.global_sort_tiles(padded, tile=8192)
    want = gs.global_sort_ref(padded)
    del padded
    assert torch.equal(got, want)


def test_k7_sorts_2_to_the_29_plus_1_pairs(dev):
    """2^29 + 1 pairs padded to 2^30 (about 24 GiB with the plain
    version), bit for bit (both stable)."""
    n = (1 << 29) + 1
    keys = bb.to_tiles_pow2(duplicates(n, dev, 12), 8192)
    vals = torch.zeros_like(keys)
    vals[:n] = torch.arange(n, dtype=torch.int32, device=dev)
    got = gkv.global_sort_kv_tiles(keys, vals, tile=8192)
    want = gkv.global_sort_kv_ref(keys, vals)
    del keys, vals
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sorts_of_two_values_at_2_to_the_25(dev):
    """Skewed digits: every pass sees two digit values (one in the first
    three), as the heavy hitter's tagged count does."""
    n = 1 << 25
    keys = sort_keys_of("two values", n, dev, 4)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    assert torch.equal(gs.global_sort_tiles(keys, tile=8192),
                       gs.global_sort_ref(keys))
    got = gkv.global_sort_kv_tiles(keys, vals, tile=8192)
    want = gkv.global_sort_kv_ref(keys, vals)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


def heavy_band(kind, tile, dev):
    """(sorted R, sorted S) with wide bands of hot keys: one key over many
    chunks; two hot keys whose runs meet inside a chunk, R holding copies of
    both; a run ending mid-chunk into distinct keys; one tile whose band is
    2^14 chunks among 64 ordinary ones."""
    n = 64 * tile
    r = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    s = [r]
    if kind == "one key":
        s.append(torch.full((40 * tile,), 5000, dtype=torch.int32, device=dev))
    elif kind == "two hot keys":
        r = torch.sort(torch.cat([r[:n - 64], torch.full(
            (32,), 5000, dtype=torch.int32, device=dev), torch.full(
            (32,), 5001, dtype=torch.int32, device=dev)])).values
        s += [torch.full((20 * tile + 3001,), 5000, dtype=torch.int32,
                         device=dev),
              torch.full((9 * tile + 77,), 5001, dtype=torch.int32,
                         device=dev)]
    elif kind == "run into distinct keys":
        s.append(torch.full((17 * tile + tile // 3,), 9000,
                            dtype=torch.int32, device=dev))
    else:   # "2^14 chunks"
        s.append(torch.full(((1 << 14) * tile,), 3 * tile + 5,
                            dtype=torch.int32, device=dev))
    return r, torch.sort(torch.cat(s)).values


@pytest.mark.parametrize("tile", bc.KERNEL_TILES)
@pytest.mark.parametrize("kind", ["one key", "two hot keys",
                                  "run into distinct keys", "2^14 chunks"])
def test_k4_heavy_bands_match_plain(dev, tile, kind):
    r, s = heavy_band(kind, tile, dev)
    r_flat = bb.to_tiles(r, tile)
    s_pad = bb.prepare_probe_side(s, tile)
    mins, maxs, _ = st.tile_stats(r_flat, tile)
    row_off, rows_needed = bb._rows(*bb._slice_offsets(s, mins, maxs))
    n_chunks = bb._n_chunks(rows_needed, tile)
    n_chunks[7] = 0
    assert int(n_chunks.max()) > bc.ITEM_CHUNKS
    got = bc.banded_count(r_flat, s_pad, row_off, n_chunks, tile=tile)
    torch.cuda.synchronize()
    want = bc.banded_count_ref(r_flat, s_pad, row_off, n_chunks, tile=tile)
    assert torch.equal(got[0], want[0]) and not got[1].any()
    assert int(got[0][7]) == 0


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
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].max()) == 1                  # the heavy run's tiles
    k1 = fsc.fused_sort_count(*args, tile=tile, method="bitonic")
    assert torch.equal(k1[2], got[0]) and torch.equal(k1[3], got[1])
    assert torch.equal(k1[4], got[2]) and torch.equal(k1[5], got[2])


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


def zipf1_keys(n, alphabet, seed, dev):
    """Zipf(1.0) draws over a permuted alphabet 1..alphabet: a float64
    table of the cumulative distribution, a binary search a draw."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    weights = torch.arange(1, alphabet + 1, dtype=torch.float64,
                           device=dev).reciprocal_()
    cdf = torch.cumsum(weights, 0).div_(weights.sum())
    keys = torch.randperm(alphabet, generator=gen, dtype=torch.int32,
                          device=dev).add_(1)
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=dev)
    return keys[torch.searchsorted(cdf, u).clamp_(max=alphabet - 1)]


def test_mass_overflow_of_a_sorted_plan_recounts_in_place(dev):
    """2^20 x 2^24 Zipf(1.0) sort-first: more than max(4, F/8) = 16 of 128
    tiles flag, and one more K4 launch recounts them exactly, with no K3
    key beyond R and S and within 10 % of the memory of the same join
    whose bands all fit (``max_chunks`` past the widest band)."""
    nr, ns = 1 << 20, 1 << 24
    r = shuffled_keys(nr, 5, dev)
    s = zipf1_keys(ns, nr, 6, dev)
    r_sorted = torch.sort(r).values
    want = int((torch.searchsorted(r_sorted, s, right=True)
                - torch.searchsorted(r_sorted, s)).sum())
    runs = []
    for max_chunks in (bb.MAX_CHUNKS_DEFAULT, 256):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        k4, keys = bc.LAUNCHES, gs.SORTED_KEYS
        out = bb.banded_join_pipelined(r, s, presort=True, sort_s=True,
                                       max_chunks=max_chunks)
        runs.append((out, bc.LAUNCHES - k4, gs.SORTED_KEYS - keys,
                     torch.cuda.max_memory_allocated() - base))
    (mass, k4_mass, keys_mass, peak_mass), (fit, k4_fit, keys_fit,
                                            peak_fit) = runs
    assert mass.overflow_tiles > 16 and mass.resorted
    assert fit.overflow_tiles == 0 and not fit.resorted
    assert mass.matches == fit.matches == want == ns
    assert (k4_mass, k4_fit) == (2, 1)
    assert keys_mass == keys_fit == nr + ns
    assert abs(peak_mass - peak_fit) <= 0.1 * peak_fit


def test_heavy_hitter_of_a_presorted_plan_counts_2_to_the_40(dev):
    """One key in every row of R and S, 2^20 each: all 128 tiles flag and
    the in-place recount counts 2^40 pairs from the bands' ends, each tile
    holding one key, with a K4 launch that walks no chunk."""
    heavy = torch.full((1 << 20,), 3, dtype=torch.int32, device=dev)
    k4, keys = bc.LAUNCHES, gs.SORTED_KEYS
    out = bb.banded_join_pipelined(heavy, heavy, presorted=True)
    assert out.matches == 1 << 40 and out.overflow_tiles == 128
    assert out.resorted and out.output_sum == out.input_sum == 3 << 20
    assert bc.LAUNCHES - k4 == 2 and gs.SORTED_KEYS == keys


@pytest.mark.parametrize("algo,fields", [
    ("nocc", dict(data_distr=Distribution.UNIFORM, distinct_keys=1 << 14)),
    ("nocc", dict(data_distr=Distribution.RANDOM)),
    ("nocc", dict(data_distr=Distribution.SHUFFLE, backend="xla",
                  enable_probe=False)),
    ("atomic", dict(data_distr=Distribution.UNIFORM, distinct_keys=1 << 14)),
    ("atomic", dict(data_distr=Distribution.SHUFFLE, backend="xla")),
    ("htm", dict(data_distr=Distribution.UNIFORM, distinct_keys=1 << 14,
                 backend="xla", track=True, adaptive=True)),
    ("htm", dict(data_distr=Distribution.RANDOM)),
    ("htm", dict(data_distr=Distribution.ZIPF, enable_probe=False)),
    ("npo", dict(data_distr=Distribution.UNIFORM, backend="xla")),
    ("npo_st", dict(data_distr=Distribution.PK, s_distr=Distribution.FK,
                    s_size=1 << 17)),
    ("sortmerge", dict(data_distr=Distribution.RANDOM))])
def test_scatter_builds_on_the_card_equal_the_cpu(dev, algo, fields):
    """The winner of a slot is the highest row on the card (atomicMax) as
    on the CPU, so the two lines agree on every field but the times, nocc's
    losses included."""
    cfg = JoinConfig(algo=Algo(algo), r_size=1 << 16, **fields)
    r, s = build_relations(cfg, dev)
    probing = cfg.enable_probe
    cpu_r = Relation(r.keys.cpu())
    cpu_s = Relation(s.keys.cpu(), assume_sorted=s.assume_sorted)
    got = DISPATCH[algo](r, s if probing else None, cfg).to_dict()
    want = DISPATCH[algo](cpu_r, cpu_s if probing else None, cfg).to_dict()
    assert "backend" not in got
    assert {k: v for k, v in got.items() if "Time" not in k} == \
        {k: v for k, v in want.items() if "Time" not in k}


def claim_keys(kind, n, dev, seed=0):
    """Build keys for the claim rounds: a permutation of 1..n; the same
    with row 0's key 0 (EMPTY); uniform draws over 1..2^14, or over
    0..2^14 with row 0's key 0 too; or nonzero draws over all of int32."""
    if kind == "shuffled":
        return shuffled_keys(n, seed, dev)
    if kind == "zero_first":
        keys = shuffled_keys(n, seed, dev)
        keys[0] = 0
        return keys
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if kind in ("uniform", "zeros"):
        keys = torch.randint(int(kind == "uniform"), (1 << 14) + 1, (n,),
                             generator=gen, device=dev, dtype=torch.int32)
        if kind == "zeros":
            keys[0] = 0
        return keys
    keys = torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                         device=dev, dtype=torch.int64).to(torch.int32)
    return torch.where(keys == 0, 1, keys)


def murmur_hash(keys, mask):
    return hashing.murmur32(keys) & mask


def assert_claims_equal_the_cpu(build, keys, rounds, *args):
    """``build(keys, *args)`` on the card: one kernel build with n rows a
    round in ``CLAIM_ROWS``, and every output equal to the CPU's torch
    claim rounds, bit for bit."""
    launches, rows = insert.LAUNCHES, insert.CLAIM_ROWS
    got = build(keys, *args)
    torch.cuda.synchronize()
    assert insert.LAUNCHES == launches + 1
    assert insert.CLAIM_ROWS - rows == rounds * keys.numel()
    want = build(keys.cpu(), *args)
    assert insert.LAUNCHES == launches + 1
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)
    return got


@pytest.mark.parametrize("kind,n,size,budget,hash_fn", [
    ("shuffled", 1 << 20, 1 << 21, 4, hashing.identity_hash),   # the cell's
    ("uniform", 1 << 20, 1 << 21, 4, hashing.identity_hash),
    ("shuffled", 3 * 1024 + 5, 1 << 11, 4, hashing.identity_hash),
    ("uniform", (1 << 18) - 77, 1 << 17, 4, hashing.identity_hash),
    ("shuffled", 1 << 18, 1 << 19, 4, murmur_hash),
    ("uniform", (1 << 18) + 3, 1 << 18, 4, murmur_hash),
    ("signed", (1 << 18) - 1, 1 << 18, 4, hashing.identity_hash),
    ("signed", 1 << 18, 1 << 17, 3, hashing.locality_hash),
    ("uniform", 1 << 18, 1 << 19, 1, hashing.identity_hash),
    ("uniform", (1 << 18) + 9, 1 << 18, 6, hashing.identity_hash),
    ("shuffled", 1 << 20, 1 << 19, 6, murmur_hash),
    ("uniform", 100, 4, 6, hashing.identity_hash),
    ("zero_first", (1 << 16) + 3, 1 << 17, 1, hashing.identity_hash),
    ("zero_first", 1 << 16, 1 << 17, 4, hashing.identity_hash),
    ("zeros", 1 << 18, 1 << 19, 4, hashing.identity_hash),
    ("zeros", (1 << 18) - 3, 1 << 17, 1, hashing.identity_hash),
    ("zeros", 1 << 18, 1 << 18, 4, murmur_hash),
    ("zeros", (1 << 18) + 1, 1 << 18, 6, hashing.identity_hash)])
def test_claim_kernel_open_addressing_equals_the_plain_rounds(
        dev, kind, n, size, budget, hash_fn):
    """The open-addressing build's table and pending mask, kernel against
    the plain torch rounds: the cell's shape at 2^20, slots with many
    attempters, tables of next_pow2(n) / 2 that spill, the murmur hash,
    ragged n, signed keys, budgets 1 and 4 (the packed word) and 6 (two
    launches a round), a budget cut to the table's 4 slots, and key 0
    (EMPTY): placed, it leaves its slot empty for later rounds, and row
    0's key 0 places in the last round."""
    keys = claim_keys(kind, n, dev, seed=n % 97)
    table, pending = assert_claims_equal_the_cpu(
        insert.open_addressing_build, keys, min(budget, size), size, budget,
        hash_fn)
    if kind in ("uniform", "zeros") or size < n:
        assert 0 < int(pending.sum()) < n
    elif kind == "shuffled" and hash_fn is hashing.identity_hash:
        assert int(pending.sum()) == 0 and int((table != 0).sum()) == n
    elif kind == "zero_first":
        assert int(pending.sum()) == 0 and int((table != 0).sum()) == n - 1


@pytest.mark.parametrize("kind,n,slots,shrink,hash_fn", [
    ("shuffled", 1 << 18, 2, 1, hashing.identity_hash),          # npo
    ("uniform", (1 << 18) - 5, 2, 4, hashing.identity_hash),
    ("uniform", 1 << 18, 3, 1, hashing.locality_hash),
    ("signed", (1 << 18) + 1, 3, 2, hashing.locality_hash),
    ("uniform", 1 << 18, 5, 2, hashing.identity_hash),           # 2 launches
    ("shuffled", 1 << 18, 4, 8, murmur_hash),
    ("zeros", 1 << 18, 2, 4, hashing.identity_hash),
    ("zeros", (1 << 18) + 7, 3, 2, hashing.locality_hash)])
def test_claim_kernel_buckets_equal_the_plain_rounds(dev, kind, n, slots,
                                                     shrink, hash_fn):
    """``bucket_build`` through the kernel's bucket slot rule h * S + j:
    npo's 2-slot buckets, 3-slot buckets under the locality hash, 4 slots
    (the packed word's last class) and 5 (two launches a round), into
    n // 2 // shrink buckets; key 0 among the keys."""
    keys = claim_keys(kind, n, dev, seed=slots)
    nb = 1 << ((n // 2 // shrink).bit_length() - 1)
    assert_claims_equal_the_cpu(insert.bucket_build, keys, slots, nb, slots,
                                hash_fn)


@pytest.mark.parametrize("kind", ["shuffled", "uniform", "wrapped",
                                  "signed", "zeros"])
def test_claim_kernel_htm_retry_equals_the_plain_rounds(dev, kind):
    """The HTM build's retry rounds through the kernel, seeded with the
    optimistic scatter's table (the seeded word's class above the three
    rounds): table, pending and failed masks equal the CPU's, on unique
    keys, duplicates, keys that wrap the buckets, signed keys and
    duplicates with key 0."""
    n = (1 << 18) + 11
    keys = (claim_keys("shuffled", n, dev) * 3 if kind == "wrapped"
            else claim_keys(kind, n, dev, seed=5))
    nb = 1 << (n // 3).bit_length()
    launches, rows = insert.LAUNCHES, insert.CLAIM_ROWS
    got = insert.htm_optimistic_build(keys, nb, retry=True)
    torch.cuda.synchronize()
    assert insert.LAUNCHES == launches + 1
    assert insert.CLAIM_ROWS - rows == 4 * n
    want = insert.htm_optimistic_build(keys.cpu(), nb, retry=True)
    assert insert.LAUNCHES == launches + 1
    for field in ("table", "pending", "failed_optimistic"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field))
    if kind != "shuffled":
        assert int(want.failed_optimistic.sum()) > 0


def test_atomic_join_runs_the_claim_kernel(dev):
    """The hash cell's path at 2^20 (``--algo atomic --backend xla`` on
    shuffled keys): one kernel build, claimRows 4 n, and the CPU's line."""
    cfg = JoinConfig(algo=Algo.ATOMIC, r_size=1 << 20, backend="xla",
                     data_distr=Distribution.SHUFFLE)
    r, s = build_relations(cfg, dev)
    before = insert.LAUNCHES
    got = DISPATCH["atomic"](r, s, cfg).to_dict()
    assert insert.LAUNCHES == before + 1
    assert got["claimRows"] == 4 * cfg.r_size
    assert got["totalMatches"] == cfg.r_size
    assert got["inputSum"] == got["outputSum"]


def probe_keys(kind, m, rkeys, seed):
    """m S keys for the table probe: 1..m in order; 1..m shuffled; or edge
    keys, shuffled: half drawn from R, the rest 0 (EMPTY, which counts the
    empty slots it scans), INT32_MIN, INT32_MAX, negatives and draws over
    all of int32."""
    dev = rkeys.device
    if kind == "sorted":
        return sorted_keys(m, dev)
    if kind == "shuffled":
        return shuffled_keys(m, seed, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    half = rkeys[torch.randint(0, rkeys.numel(), (m // 2,), generator=gen,
                               device=dev)]
    wide = torch.randint(-(1 << 31), 1 << 31, (m - m // 2,), generator=gen,
                         device=dev, dtype=torch.int64).to(torch.int32)
    wide[::5], wide[1::5], wide[2::5] = 0, -(1 << 31), MAXI32
    wide[3::5] = -(wide[3::5].abs() % 9) - 1
    keys = torch.cat([half, wide])
    return keys[torch.randperm(m, generator=gen, device=dev)]


def assert_probe_equals_the_plain_version(probe_fn, ref_fn, table, skeys,
                                          *args):
    """``probe_fn(table, skeys, *args)`` on the card: one kernel launch, an
    int64 device scalar equal to the plain version's count on the card and
    on the CPU."""
    launches = probe.LAUNCHES
    got = probe_fn(table, skeys, *args)
    torch.cuda.synchronize()
    assert probe.LAUNCHES == launches + 1
    assert got.is_cuda and got.dtype == torch.int64 and got.dim() == 0
    cpu = probe_fn(table.cpu(), skeys.cpu(), *args)
    assert probe.LAUNCHES == launches + 1
    assert int(got) == int(ref_fn(table, skeys, *args)) == int(cpu)
    return int(got)


@pytest.mark.parametrize("kind,n,size,budget,hash_fn,s_kind", [
    ("shuffled", 1 << 20, 1 << 21, 4, hashing.identity_hash, "sorted"),
    ("shuffled", 1 << 18, 1 << 19, 1, hashing.identity_hash, "shuffled"),
    ("shuffled", 1 << 18, 1 << 19, 6, hashing.identity_hash, "edges"),
    ("uniform", (1 << 18) + 9, 1 << 17, 4, hashing.identity_hash, "edges"),
    ("uniform", 1000, 16, 40, hashing.identity_hash, "edges"),
    ("signed", 1 << 18, 1 << 18, 4, hashing.locality_hash, "edges"),
    ("shuffled", 1 << 18, 1 << 19, 4, murmur_hash, "shuffled"),
    ("uniform", 1 << 18, 1 << 17, 6, murmur_hash, "edges"),
    ("zeros", 1 << 16, 1 << 17, 4, hashing.identity_hash, "edges"),
    ("uniform", 100, 1, 4, hashing.identity_hash, "edges"),
    ("uniform", 100, 2, 4, hashing.identity_hash, "edges")])
def test_probe_kernel_open_addressing_equals_the_plain_version(
        dev, kind, n, size, budget, hash_fn, s_kind):
    """``probe_open_addressing`` on the card against its plain version on
    a kernel-built table: the cell's shape at 2^20 (sorted S), budgets 1,
    4 and 6 and one above the table's 16 slots, tables of 1 and 2 slots,
    duplicates that fill the spill, signed keys under the locality hash,
    the handed-over murmur hash, a table holding key 0, an unsorted S, and
    S keys 0 (against empty slots), INT32_MIN, INT32_MAX and negatives."""
    rkeys = claim_keys(kind, n, dev, seed=n % 89)
    table, pending = insert.open_addressing_build(rkeys, size, budget,
                                                  hash_fn)
    if kind == "uniform":
        assert int(pending.sum()) > 0
    skeys = probe_keys(s_kind, n + 3, rkeys, seed=size % 97)
    got = assert_probe_equals_the_plain_version(
        probe.probe_open_addressing, probe.probe_open_addressing_ref, table,
        skeys, budget, hash_fn)
    assert got > 0 or size < 16
    if s_kind == "sorted":
        assert got == n


@pytest.mark.parametrize("kind,n,slots,shrink,hash_fn,s_kind", [
    ("shuffled", 1 << 18, 2, 1, hashing.identity_hash, "sorted"),    # npo
    ("shuffled", (1 << 18) + 1, 3, 1, hashing.locality_hash, "sorted"),
    ("uniform", 1 << 18, 3, 2, hashing.locality_hash, "edges"),
    ("signed", 1 << 18, 2, 4, murmur_hash, "shuffled"),
    ("zeros", (1 << 18) + 7, 2, 4, hashing.identity_hash, "edges")])
def test_probe_kernel_buckets_equals_the_plain_version(dev, kind, n, slots,
                                                       shrink, hash_fn,
                                                       s_kind):
    """``probe_buckets`` on the card against its plain version on a
    kernel-built table of 2- and 3-slot buckets (npo's, htm's), each hash
    kind, duplicates that fill the spill, and edge S keys."""
    rkeys = claim_keys(kind, n, dev, seed=slots)
    nb = 1 << ((n // 2 // shrink).bit_length() - 1)
    table, pending = insert.bucket_build(rkeys, nb, slots, hash_fn)
    skeys = probe_keys(s_kind, n, rkeys, seed=slots + shrink)
    got = assert_probe_equals_the_plain_version(
        probe.probe_buckets, probe.probe_buckets_ref, table, skeys, slots,
        hash_fn)
    assert got > 0
    if s_kind == "sorted" and int(pending.sum()) == 0:
        assert got == n


@pytest.mark.parametrize("start,length", [
    (0, 0), (0, 1), (0, 2), (0, 3), (0, 5), (0, 7), (0, 1023), (1, 1),
    (1, 4), (1, 1022), (2, 1021), (3, 1020), (1, 5), (3, 0)])
def test_probe_kernel_on_short_and_misaligned_s(dev, start, length):
    """S of length 0, 1 and lengths that are no multiple of the kernel's
    four keys a load, and views that start off a 16-byte boundary
    (``skeys[1:]`` and the like): each key counted once, in both
    addressings, equal to the plain version."""
    rkeys = claim_keys("uniform", 1 << 12, dev, seed=7)
    base = probe_keys("edges", 1024, rkeys, seed=start + length)
    skeys = base[start:start + length]
    assert skeys.is_contiguous()
    table, _ = insert.open_addressing_build(rkeys, 1 << 11, 4,
                                            hashing.identity_hash)
    assert_probe_equals_the_plain_version(
        probe.probe_open_addressing, probe.probe_open_addressing_ref, table,
        skeys, 4, hashing.identity_hash)
    table, _ = insert.bucket_build(rkeys, 1 << 10, 3, hashing.locality_hash)
    assert_probe_equals_the_plain_version(
        probe.probe_buckets, probe.probe_buckets_ref, table, skeys, 3,
        hashing.locality_hash)


def test_atomic_join_runs_the_probe_kernel(dev):
    """The hash cell's path at 2^20: one probe kernel launch a probing
    scatter join, none on a build-only one."""
    cfg = JoinConfig(algo=Algo.ATOMIC, r_size=1 << 20, backend="xla",
                     data_distr=Distribution.SHUFFLE)
    r, s = build_relations(cfg, dev)
    before = probe.LAUNCHES
    got = DISPATCH["atomic"](r, s, cfg).to_dict()
    assert probe.LAUNCHES == before + 1
    assert got["totalMatches"] == cfg.r_size
    build_only = dataclasses.replace(cfg, enable_probe=False)
    DISPATCH["atomic"](r, None, build_only)
    assert probe.LAUNCHES == before + 1


def scatter_case(keys, tile, fanout, shift, align=False):
    """One radix pass's K6 inputs: the tile-sorted keys and their plan."""
    sorted_flat, _ = st.sort_tiles(rk._to_tiles(keys, tile), tile=tile,
                                   method="bitonic")
    bounds = rk.tile_digit_bounds(sorted_flat, fanout=fanout, shift=shift,
                                  tile=tile)
    parent = torch.zeros(bounds.shape[0], dtype=torch.int32,
                         device=keys.device)
    plan = rk.scatter_plan(bounds, parent, fanout=fanout,
                           rows_per_tile=tile // 128, align_tiles=align,
                           n_parents=1)
    return sorted_flat, plan


@pytest.mark.parametrize("tile", [2048, 8192])
@pytest.mark.parametrize("kind,fanout,shift", [
    ("permutation", 8, 15), ("permutation", 128, 8),
    ("alphabet 1..3", 4, 0), ("duplicates", 128, 4)])
def test_k6_matches_plain(dev, tile, kind, fanout, shift):
    n = 5 * tile - 300
    if kind == "permutation":
        keys = shuffled_keys(n, 3, dev)
    elif kind == "alphabet 1..3":             # runs of many rows, empty runs
        keys = duplicates(n, dev, 5) % 3 + 1
    else:
        keys = duplicates(n, dev, 6)
    sorted_flat, plan = scatter_case(keys, tile, fanout, shift,
                                     align=kind == "duplicates")
    args = (sorted_flat, plan.a_elem, plan.dest_row)
    kw = dict(tile=tile, out_rows=plan.out_rows)
    before = sct.LAUNCHES
    got = sct.scatter_tiles(*args, **kw)
    torch.cuda.synchronize()
    assert sct.LAUNCHES == before + 1
    assert torch.equal(got, sct.scatter_tiles_ref(*args, **kw))
    vals = got[got != MAXI32]
    assert torch.equal(torch.sort(vals).values, torch.sort(keys).values)


@pytest.mark.parametrize("passes,bits", [(2, 6), (3, 9), (2, 14)])
def test_multipass_partition_on_the_card_equals_the_cpu(dev, passes, bits):
    keys = shuffled_keys((1 << 16) + 77, 4, dev)
    kw = dict(radix_bits=bits, passes=passes, key_bits=17, tile=2048)
    before = sct.LAUNCHES
    got = rk.multipass_radix_partition(keys, **kw)
    assert sct.LAUNCHES == before + len(got.pass_plans)
    want = rk.multipass_radix_partition(keys.cpu(), **kw)
    assert torch.equal(got.partitioned.cpu(), want.partitioned)
    for g, w in zip(got.pass_hists, want.pass_hists):
        assert torch.equal(g.cpu(), w)


def test_multipass_radix_join_on_the_card(dev):
    n = 1 << 20
    cfg = JoinConfig(algo=Algo.RADIX, r_size=n, data_distr=Distribution.PK,
                     radix_bits=14, radix_passes=2, radix_strategy="multipass")
    r, s = build_relations(cfg, dev)
    before = sct.LAUNCHES
    m = radix_join(r, s, cfg)
    assert sct.LAUNCHES == before + 2
    assert m.totalMatches == n and m.inputSum == m.outputSum == n * (n + 1) // 2
    assert m.extra["passBits"] == [7, 7]
    build_only = radix_join(r, None, cfg)
    assert build_only.inputSum == build_only.outputSum


@pytest.mark.parametrize("argv,path", [
    (["--algo", "adaptive", "--dataDistr", "local_shuffle"], "htm"),
    (["--algo", "adaptive", "--dataDistr", "uniform", "--distinctKeys",
      "524288"], "radix"),
    (["--algo", "adaptive", "--dataDistr", "random"], "radix"),
    (["--algo", "PRO", "-r", "1048576", "-s", "2097152"], None),
    (["--algo", "htm", "--switchSniff", "--dataDistr", "zipf"], None)])
def test_cli_paths_on_the_card(dev, capsys, argv, path):
    n = 1 << 20
    if "-r" not in argv:
        argv = argv + ["--rSize", str(n)]
    assert cli.main(argv, device=dev) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["inputSum"] == line["outputSum"]
    assert line.get("chosenPath") == path
    if "--switchSniff" in argv:
        assert line["switchedToRadix"] and line["totalMatches"] == n
    elif "-s" in argv:
        assert line["totalMatches"] == 2 * n
    elif "random" not in argv:
        assert line["totalMatches"] == n
    else:
        cfg, _ = cli.parse_args(argv)
        r, _ = build_relations(cfg, dev)
        _, counts = torch.unique(r.keys, return_counts=True)
        assert line["totalMatches"] == int((counts.long() ** 2).sum())


def kv_pairs(keys, vals):
    """A key-value sort's (key, value) multiset: sorted int64 composites."""
    return torch.sort((keys.long() << 32) | (vals.long() & 0xFFFFFFFF)).values


@pytest.mark.parametrize("tile", [2048, 8192, 16384])
@pytest.mark.parametrize("n_tiles", [1, 2, 8, 64])
@pytest.mark.parametrize("kind", SORT_KINDS + ["padded"])
def test_k7_matches_plain(dev, tile, n_tiles, kind):
    """The radix sort is stable, so it equals the plain stable sort + gather
    bit for bit; K7a is not launched."""
    n = tile * n_tiles
    keys = sort_keys_of("duplicates" if kind == "padded" else kind, n, dev, 5)
    if kind == "padded":
        keys[n - 999:] = MAXI32
    vals = duplicates(n, dev, 7) - n // 14
    before = (skv.LAUNCHES, gkv.LAUNCHES)
    got = gkv.global_sort_kv_tiles(keys, vals, tile=tile)
    torch.cuda.synchronize()
    assert (skv.LAUNCHES, gkv.LAUNCHES) == (before[0], before[1] + 1)
    want = gkv.global_sort_kv_ref(keys, vals)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


K7A_KINDS = ["all equal", "sorted", "reversed", "16 copies a key",
             "MAXI32 padding in the last block", "INT32_MIN and negatives"]


def k7a_case(kind, tile, n_tiles, dev, seed=0):
    """(keys, values) of n_tiles tiles (the kinds of
    tests/test_torch_sort_kv.py); the values are distinct, so a tie out of
    input order shows."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = tile * n_tiles
    wide = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    if kind == "all equal":
        keys = torch.full((n,), -7, dtype=torch.int32, device=dev)
    elif kind == "sorted":
        keys = torch.sort(wide >> 20).values
    elif kind == "reversed":
        keys = torch.sort(wide >> 20, descending=True).values
    elif kind in ("16 copies a key", "MAXI32 padding in the last block"):
        keys = torch.randint(0, max(1, n // 16), (n,), generator=gen,
                             device=dev, dtype=torch.int32)
        if kind != "16 copies a key":
            keys[n - tile // 2 - 5:] = MAXI32
    else:
        keys = wide.clone()
        keys[::97] = -2**31
        keys[1::89] = MAXI32
        keys[2::13] = -1
    vals = (torch.randperm(n, generator=gen, device=dev) - n // 2).int()
    return keys, vals


@pytest.mark.parametrize("tile", skv.KERNEL_TILES)
@pytest.mark.parametrize("alternate", [False, True])
@pytest.mark.parametrize("kind", K7A_KINDS)
@pytest.mark.parametrize("n_tiles", [1, 64])
def test_k7a_matches_plain(dev, tile, alternate, kind, n_tiles):
    """The kernel sorts (key, row) composites, so it is stable and equals
    the plain stable sort + gather bit for bit, descending tiles too."""
    keys, vals = k7a_case(kind, tile, n_tiles, dev, seed=tile + n_tiles)
    before = skv.LAUNCHES
    got = skv.sort_kv_tiles(keys, vals, tile=tile, alternate=alternate)
    torch.cuda.synchronize()
    assert skv.LAUNCHES == before + 1
    want = skv.sort_kv_tiles_ref(keys, vals, tile=tile, alternate=alternate)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("tile", [1024, 32768])
def test_k7a_refuses_a_tile_outside_its_kernel_tiles(dev, tile):
    keys = torch.zeros(2 * tile, dtype=torch.int32, device=dev)
    before = skv.LAUNCHES
    with pytest.raises(ValueError, match="takes tile in"):
        skv.sort_kv_tiles(keys, keys.clone(), tile=tile)
    assert skv.LAUNCHES == before


@pytest.mark.parametrize("algo", ["parallel", "independent", "radix"])
def test_kv_split_on_the_card(dev, algo):
    """At the kv gate's 2^22 rows the split goes through K7 on the card;
    sizes and offsets equal the CPU's stable split."""
    from htm_hashjoin_tpu_torch import wisconsin as P
    n = 1 << 22
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    keys = torch.randint(1, 1 << 24, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    rid = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    node = {"algorithm": algo, "pagesize": 131072, "attribute": 1}
    hash_node = {"fn": "modulo", "range": [1, 1 << 24], "buckets": 2048,
                 "skipbits": 12}
    splits = []
    for d in (dev, torch.device("cpu")):
        t = P.WriteTable(P.Schema.create(("long", "long")), 131072, d)
        t.append_batch([keys.to(d), rid.to(d)])
        t.finalize()
        before = gkv.LAUNCHES
        splits.append(P.partitioner_factory(node, hash_node, 8).split(t))
        assert gkv.LAUNCHES == before + (d.type == "cuda")
    got, want = splits
    assert (got.sizes == want.sizes).all() and \
        (got.offsets == want.offsets).all()
    for p in range(0, 2048, 97):
        seg = slice(int(want.offsets[p]), int(want.offsets[p] + want.sizes[p]))
        assert torch.equal(
            kv_pairs(*(c[seg].cpu() for c in got.table.columns)),
            kv_pairs(*(c[seg] for c in want.table.columns)))


@pytest.mark.parametrize("name", ["no_partition", "independent", "steal"])
def test_multijoin_confs_on_the_card(dev, name):
    """A shipped conf cut to 2^20 ⋈ 2^24 (the kv gate passes on the probe
    side): the output, as (build rid, probe rid) pairs, equals a plain join
    of the same tables (made anew from the conf's seeds on the card)."""
    import os
    from htm_hashjoin_tpu_torch import wisconsin as P
    from htm_hashjoin_tpu_torch.wisconsin.driver import load_side
    conf = P.parse_conf(os.path.join(os.path.dirname(__file__), "..",
                                     "htm_hashjoin_tpu", "wisconsin", "conf",
                                     f"{name}.conf"))
    for side, size in (("build", 1 << 20), ("probe", 1 << 24)):
        conf[side]["relation-size"] = size
        conf[side]["alphabet-size"] = 1 << 20
    before = gkv.LAUNCHES
    res = P.run_multijoin(conf, device=dev)
    assert (gkv.LAUNCHES > before) == (name != "no_partition")
    line = json.loads(res.to_json_line())
    assert line["outputRows"] == 1 << 24 and line["buildRows"] == 1 << 20
    build = load_side(conf["build"], ".", 1 << 20, dev)
    probe = load_side(conf["probe"], ".", 1 << 20, dev)
    rid_of_key = torch.zeros((1 << 20) + 1, dtype=torch.int32, device=dev)
    rid_of_key[build.column(1).long()] = build.column(2)
    want = kv_pairs(rid_of_key[probe.column(1).long()], probe.column(2))
    assert torch.equal(kv_pairs(res.output.column(1), res.output.column(2)),
                       want)


def test_testbed_copy_rate_is_under_the_data_sheet(dev):
    """The card's own copy rate: a chain of dependent device copies, read
    plus write, at most the H100's 3.35 TB/s (5 % for the clock)."""
    from htm_hashjoin_tpu_torch.benchmarks import memory_bandwidth
    rep = memory_bandwidth(26, reps=3, device=dev)
    assert rep["device"] == torch.cuda.get_device_name(dev)
    assert 0 < rep["gbps"] <= 3350 * 1.05
    assert 0 < rep["gbpsSingleFenced"] <= 3350 * 1.05


@pytest.mark.parametrize("argv", [
    ["--algo", "htm", "--dataDistr", "local_shuffle"],
    ["--algo", "atomic", "--backend", "xla", "--noProbe", "--dataDistr",
     "shuffle"],
    ["--algo", "htm", "--dataDistr", "pk", "--sSize", "4194304"]])
def test_counters_bandwidth_is_under_the_copy_rate(dev, capsys, argv):
    from htm_hashjoin_tpu_torch.benchmarks import memory_bandwidth
    rate = memory_bandwidth(26, reps=3, device=dev)["gbps"]
    n = 1 << 22
    assert cli.main(argv + ["--rSize", str(n), "--counters", "--throughput"],
                    device=dev) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line, rep = json.loads(out[-2]), json.loads(out[-1])
    assert line["inputSum"] == line["outputSum"]
    for events in line["counters"].values():
        assert set(events) == {"flops", "bytes", "intensity", "bandwidth"}
        assert 0 <= events["bandwidth"] <= rate * 1.05
    total = line["hashBuildTimeInMicroseconds"] + (
        line.get("probeTimeInMicroseconds") or 0.0)
    assert rep["tuplesPerSecond"] == pytest.approx(
        rep["numTuples"] / (total * 1e-6))


def test_harness_grid_on_the_card_equals_the_cpu(dev, tmp_path):
    """AtomicsVsHTMVsNoCC at 2^20 (sorted and shuffled unique keys, whose
    lines do not depend on the generator's bits): every line on the card
    equals the CPU's but for the times, and the logs are written."""
    from htm_hashjoin_tpu_torch.harness import run_grid
    from htm_hashjoin_tpu_torch.harness.runner import clear_cache
    got = run_grid("AtomicsVsHTMVsNoCC", scale=20, reps=1, echo=False,
                   out_dir=str(tmp_path), device=dev)
    want = run_grid("AtomicsVsHTMVsNoCC", scale=20, reps=1, echo=False,
                    device="cpu")
    clear_cache()
    untimed = [{k: v for k, v in json.loads(line).items() if "Time" not in k}
               for line in got + want]
    assert untimed[:6] == untimed[6:]
    assert (tmp_path / "AtomicsVsHTMVsNoCC_log1").read_text().split("\n")[:6] \
        == got


def test_cached_relation_lands_on_the_card_without_a_device(dev, tmp_path):
    """A miss (a CPU generator) and a hit both give card tensors when no
    device is passed."""
    from htm_hashjoin_tpu_torch.config import Distribution, JoinConfig
    from htm_hashjoin_tpu_torch.data import persist
    from htm_hashjoin_tpu_torch.relation import Relation
    cfg = JoinConfig(r_size=1 << 12, data_distr=Distribution.SORTED)
    keys = torch.arange(1, (1 << 12) + 1, dtype=torch.int32)
    miss = persist.cached_relation(cfg, "r", str(tmp_path),
                                   lambda: Relation(keys))
    hit = persist.cached_relation(cfg, "r", str(tmp_path),
                                  lambda: pytest.fail("regenerated"))
    assert miss.keys.is_cuda and hit.keys.is_cuda
    assert torch.equal(miss.keys, hit.keys) and torch.equal(hit.keys.cpu(),
                                                            keys)


DIST_CASES = {
    "flat shuffle (8,)": dict(data_distr=Distribution.SHUFFLE,
                              mesh_shape=(8,)),
    "hierarchical shuffle (2, 4)": dict(data_distr=Distribution.SHUFFLE,
                                        mesh_shape=(2, 4)),
    "zipf skew plan (8,)": dict(data_distr=Distribution.ZIPF,
                                distinct_keys=1 << 12, zipf_param=1.2,
                                skew_handling=True, mesh_shape=(8,)),
    "zipf forced repair (2, 4)": dict(data_distr=Distribution.ZIPF,
                                      distinct_keys=1 << 12, zipf_param=1.2,
                                      shuffle_capacity_factor=1.0,
                                      mesh_shape=(2, 4)),
}


@pytest.mark.parametrize("case", sorted(DIST_CASES))
def test_distributed_join_on_the_card_equals_the_cpu(dev, tmp_path,
                                                     monkeypatch, case):
    """Eight shards on the card (a mapping file wraps them onto it) at
    2^16: the card's line equals the CPU's on the same relations but for
    the times, and is exact."""
    from htm_hashjoin_tpu_torch.parallel.dist_join import distributed_join
    from htm_hashjoin_tpu_torch.parallel.mesh import MAPPING_ENV
    path = tmp_path / "device-mapping.txt"
    path.write_text("8 0 1 2 3 4 5 6 7\n")
    monkeypatch.setenv(MAPPING_ENV, str(path))
    cfg = JoinConfig(algo=Algo.RADIX, r_size=1 << 16, **DIST_CASES[case])
    r, s = build_relations(cfg, dev)
    got = distributed_join(r, s, cfg).to_dict()
    want = distributed_join(Relation(r.keys.cpu()), Relation(s.keys.cpu()),
                            cfg).to_dict()
    assert {k: v for k, v in got.items() if "Time" not in k} == \
        {k: v for k, v in want.items() if "Time" not in k}
    rs = torch.sort(r.keys).values
    exact = int((torch.searchsorted(rs, s.keys, right=True)
                 - torch.searchsorted(rs, s.keys)).sum())
    assert got["totalMatches"] == exact and got["inputSum"] == got["outputSum"]
    assert got["droppedR"] == got["droppedS"] == 0
    if "repair" in case:
        assert got["repairedR"] + got["repairedS"] > 0


def test_entry_on_the_card_equals_the_cpu(dev):
    """The single-device entry step (2^16 keys, no kernel on it) gives the
    CPU's three numbers on the card, and the expected ones."""
    from htm_hashjoin_tpu_torch.entry import entry
    fn, args = entry(dev)
    assert all(a.is_cuda for a in args)
    got = tuple(int(x) for x in fn(*args))
    cpu_fn, cpu_args = entry("cpu")
    n = 1 << 16
    assert got == tuple(int(x) for x in cpu_fn(*cpu_args)) == (
        n, n * (n + 1) // 2, 0)


def test_dial_on_the_card(dev):
    """The adaptive dial experiment at 2^20 (true window 64, declared 2^20,
    cheap 4): every rep exact (the module raises otherwise); the declared
    plan sorts first (K3 + K5), the cheap one retries (K1 twice), the
    adaptive one runs K1 once; on the same relations each plan's line
    equals the CPU's but for the times and the launches."""
    from htm_hashjoin_tpu_torch.experiments import adaptive_dial_bench as dial
    cfg0 = JoinConfig(algo=Algo.HTM, r_size=1 << 20,
                      data_distr=Distribution.LOCAL_SHUFFLE, shuffle_range=64)
    r, s = build_relations(cfg0, dev)
    cfgs = dial.plan_configs(cfg0, 1 << 20, 4)
    lines = dial.run_plans(r, s, cfgs, reps=2, echo=False)
    by = {(d["plan"], d["rep"]): d for d in lines}
    for rep in range(2):
        declared = by[("fixed-declared", rep)]["launches"]
        assert declared.get("global_sort_tiles", 0) >= 1
        assert declared.get("banded_count_narrow", 0) >= 1
        assert by[("fixed-cheap", rep)]["launches"].get(
            "fused_sort_count") == 2
        assert by[("fixed-cheap", rep)]["resorted"] is True
        assert by[("adaptive", rep)]["launches"].get("fused_sort_count") == 1
    cpu = dial.run_plans(Relation(r.keys.cpu()),
                         Relation(s.keys.cpu(), assume_sorted=True), cfgs,
                         reps=1, echo=False)

    def untimed(d):
        return {k: v for k, v in d.items()
                if "Time" not in k and k not in ("timeUs", "launches")}
    assert [untimed(d) for d in cpu] == [untimed(by[(d["plan"], 0)])
                                         for d in cpu]


def test_crossover_on_the_card(dev):
    """The radix crossover at 2^20: both engines' outputs hold the input
    as a multiset and in their order (the module raises otherwise), the
    sort engine through K3, the multipass one through K2 and K6."""
    from htm_hashjoin_tpu_torch.experiments import (kernel_launches,
                                                    launches_since)
    from htm_hashjoin_tpu_torch.experiments import radix_crossover as rx
    before = kernel_launches()
    lines = rx.crossover([20], reps=1, radix_bits=14, device=dev, echo=False)
    assert [d["engine"] for d in lines] == list(rx.ENGINES)
    launched = launches_since(before)
    assert launched.get("global_sort_tiles") == 1
    assert launched.get("scatter_tiles") == 2
    assert launched.get("sort_tiles") == 3
