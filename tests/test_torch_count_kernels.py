"""The plain K4 (general count) and K5 (narrow count) against the JAX
package's banded_count and banded_count_narrow (Pallas, interpret mode) on
the same sorted tiles, band offsets and chunk counts, tile 2048; K4's work
list (items of a few chunks) and the plain model of its per-item count;
K5's per-tile key sums against the JAX join's sums, and the plain model of
K1's and K5's register count against the plain narrow count.

The JAX kernels return one (8, 128) grid of partial sums for all tiles, so
each tile is also run alone (its own one-tile call) to compare counts per
tile.  Tolerance 0: integer outputs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from htm_hashjoin_tpu.joins import pallas_backend as jpb
from htm_hashjoin_tpu.ops.pallas import join_kernels as jk
from htm_hashjoin_tpu_torch.joins import banded_backend as tpb
from htm_hashjoin_tpu_torch.ops import banded_count as bc
from htm_hashjoin_tpu_torch.ops import banded_count_narrow as bcn
from htm_hashjoin_tpu_torch.ops.banded_count import banded_count
from htm_hashjoin_tpu_torch.ops.banded_count_narrow import banded_count_narrow
from htm_hashjoin_tpu_torch.ops.fused_sort_count import fused_sort_count_ref
from htm_hashjoin_tpu_torch.relation import keys_from_numpy, tiles_from_numpy

TILE = 2048
RPT = TILE // 128
N = 1 << 14


def sorted_case(name):
    """(tile-sorted r2d, sorted skeys) as numpy arrays."""
    rng = np.random.default_rng(9)
    if name == "unique":
        r = np.arange(1, N + 1, dtype=np.int32)
        return jpb.to_tiles_2d(jnp.asarray(r[:N - 300]), TILE), r
    if name == "duplicates":
        r = np.sort(rng.integers(1, N // 5, N).astype(np.int32))
        s = np.sort(rng.integers(1, N // 5, N + 500).astype(np.int32))
        return jpb.to_tiles_2d(jnp.asarray(r), TILE), s
    if name == "heavy_s_run":   # one S key 6000 times: a wide band
        r = np.arange(1, N + 1, dtype=np.int32)
        s = np.sort(np.concatenate([r, np.full(6000, 2100, np.int32)]))
        return jpb.to_tiles_2d(jnp.asarray(r), TILE), s
    if name == "one_key_band":  # 12 tiles of one key: chunks of one key
        r = np.arange(1, N + 1, dtype=np.int32)
        s = np.sort(np.concatenate([r, np.full(12 * TILE, 5000, np.int32)]))
        return jpb.to_tiles_2d(jnp.asarray(r), TILE), s
    if name == "two_hot_keys":  # their runs meet inside a chunk; R has copies
        r = np.sort(np.concatenate([np.arange(1, N - 63),
                                    np.full(32, 5000), np.full(32, 5001)])
                    ).astype(np.int32)
        s = np.sort(np.concatenate([np.arange(1, N + 1),
                                    np.full(3000, 5000), np.full(5000, 5001)])
                    ).astype(np.int32)
        return jpb.to_tiles_2d(jnp.asarray(r), TILE), s
    if name == "run_into_distinct":   # a run ends mid-chunk, distinct keys on
        r = np.arange(1, N + 1, dtype=np.int32)
        s = np.sort(np.concatenate([r, np.full(4999, 9000, np.int32)]))
        return jpb.to_tiles_2d(jnp.asarray(r), TILE), s
    raise KeyError(name)


K4_CASES = ["unique", "duplicates", "heavy_s_run", "one_key_band",
            "two_hot_keys", "run_into_distinct"]


def geometry(r2d, skeys):
    mins, maxs, _ = jk.tile_stats(r2d, RPT)
    off, end = jpb._slice_offsets(jnp.asarray(skeys), mins, maxs)
    row_off = (off // 128).astype(jnp.int32)
    rows_needed = jnp.maximum((end + 127) // 128 - row_off, 0).astype(jnp.int32)
    return row_off, rows_needed


def port(*arrays):
    """numpy / jax arrays -> the port's flat int32 tensors."""
    return [tiles_from_numpy(np.asarray(a)) if np.asarray(a).ndim == 2
            else keys_from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("name", K4_CASES)
def test_plain_k4_matches_jax_kernel(name):
    """The plain K4 and the model of the kernel's per-item count (one-key
    chunks counted from their two end keys) against JAX, tile by tile."""
    r2d, skeys = sorted_case(name)
    s2d = jpb.prepare_probe_side(jnp.asarray(skeys), TILE)
    row_off, rows_needed = geometry(r2d, skeys)
    n_chunks = np.asarray((rows_needed + RPT - 1) // RPT).astype(np.int32)
    n_chunks[1] = 0                                # 0 skips a tile
    n_chunks = jnp.asarray(n_chunks)
    want = jk.banded_count(r2d, s2d, row_off, n_chunks, tile=TILE,
                           max_chunks=16, interpret=True)
    args = port(r2d, s2d, row_off, n_chunks)
    counts, status = banded_count(*args, tile=TILE)
    assert int(counts.sum()) == int(np.asarray(want, np.int64).sum())
    assert not status.any() and counts[1] == 0
    model, model_status = bc.model_count(*args, tile=TILE)
    assert torch.equal(model, counts) and torch.equal(model_status, status)
    for t in range(counts.numel()):
        one = jk.banded_count(r2d[t * RPT:(t + 1) * RPT], s2d,
                              row_off[t:t + 1], n_chunks[t:t + 1], tile=TILE,
                              max_chunks=16, interpret=True)
        assert int(counts[t]) == int(np.asarray(one, np.int64).sum()), t
    if name != "unique" and name != "duplicates":
        assert int(n_chunks.max()) > 1
    if name == "one_key_band":
        assert int(n_chunks.max()) > bc.ITEM_CHUNKS   # split in items


@pytest.mark.parametrize("name", ["unique", "duplicates", "heavy_s_run"])
def test_plain_k5_matches_jax_kernel_and_k1(name):
    r2d, skeys = sorted_case(name)
    s2d = jpb.prepare_probe_side(jnp.asarray(skeys), TILE)
    row_off, rows_needed = geometry(r2d, skeys)
    want, want_flags = jk.banded_count_narrow(r2d, s2d, row_off, rows_needed,
                                              tile=TILE, interpret=True)
    args = port(r2d, s2d, row_off, rows_needed)
    counts, flags, sums = banded_count_narrow(*args, tile=TILE)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(want_flags)[:, 0])
    assert int(counts.sum()) == int(np.asarray(want, np.int64).sum())
    for t in range(counts.numel()):
        one, _ = jk.banded_count_narrow(r2d[t * RPT:(t + 1) * RPT], s2d,
                                        row_off[t:t + 1],
                                        rows_needed[t:t + 1], tile=TILE,
                                        interpret=True)
        assert int(counts[t]) == int(np.asarray(one, np.int64).sum()), t
    # K1 on the same (already sorted) tiles gives K5's counts, flags and sums
    _, _, k1_counts, k1_flags, k1_in, k1_out = fused_sort_count_ref(
        *args, tile=TILE, method="bitonic")
    assert torch.equal(k1_counts, counts) and torch.equal(k1_flags, flags)
    assert torch.equal(k1_in, sums) and torch.equal(k1_out, sums)
    if name == "heavy_s_run":
        assert flags[1] == 1 and counts[1] == 0


def test_k4_chunk_past_the_padding_raises_on_cpu():
    keys = torch.arange(1, 2 * TILE + 1, dtype=torch.int32)
    s_pad = tpb.prepare_probe_side(keys, TILE)
    n_chunks = torch.tensor([1, s_pad.numel() // TILE + 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="prepare_probe_side"):
        banded_count(keys, s_pad, torch.zeros(2, dtype=torch.int32), n_chunks,
                     tile=TILE)


def test_plain_k4_heavy_hitter_counts_past_32_bits():
    """2^16 copies of one key on each side: 2^32 pairs, exact in int64 (the
    int32 accumulator of the JAX kernel needed a certificate here)."""
    n = 1 << 16
    keys = torch.full((n,), 5, dtype=torch.int32)
    s_pad = tpb.prepare_probe_side(keys, TILE)
    mins = torch.full((n // TILE,), 5, dtype=torch.int32)
    row_off, rows_needed = tpb._rows(*tpb._slice_offsets(keys, mins, mins))
    n_chunks = tpb._n_chunks(rows_needed, TILE)
    counts, _ = banded_count(keys, s_pad, row_off, n_chunks, tile=TILE)
    assert int(counts.sum()) == n * n == 1 << 32
    assert counts.dtype == torch.int64
    assert torch.equal(bc.model_count(keys, s_pad, row_off, n_chunks,
                                      tile=TILE)[0], counts)


@pytest.mark.parametrize("chunks", [[3, 0, 8, 9, 17, 1],
                                    [0, 16384, 5, 0],
                                    [0, 0, 0]])
def test_k4_items_cover_every_chunk_once(chunks):
    """item_plan: every chunk of every tile in exactly one item of at most
    ITEM_CHUNKS chunks; a 0-chunk tile's item covers nothing; a
    16,384-chunk tile is split over many."""
    n_chunks = torch.tensor(chunks, dtype=torch.int32)
    extra_end = bc.item_plan(n_chunks)
    seen = [[0] * c for c in chunks]
    per_tile = [0] * len(chunks)
    for k in range(bc.item_count(extra_end)):
        t, c0, nc = bc.item_range(k, n_chunks, extra_end)
        assert nc <= bc.ITEM_CHUNKS
        per_tile[t] += nc > 0
        for c in range(c0, c0 + nc):
            seen[t][c] += 1
    assert all(x == 1 for row in seen for x in row)
    assert per_tile == [-(-c // bc.ITEM_CHUNKS) for c in chunks]
    if 16384 in chunks:
        assert per_tile[chunks.index(16384)] == 16384 // bc.ITEM_CHUNKS


def test_k4_model_gives_status_2_past_the_end():
    """The kernel's model reads nothing of a band past the end of S: count
    0, status 2 (the plain version raises there)."""
    keys = torch.arange(1, 2 * TILE + 1, dtype=torch.int32)
    s_pad = tpb.prepare_probe_side(keys, TILE)
    n_chunks = torch.tensor([1, s_pad.numel() // TILE + 1], dtype=torch.int32)
    counts, status = bc.model_count(keys, s_pad,
                                    torch.zeros(2, dtype=torch.int32),
                                    n_chunks, tile=TILE)
    assert counts.tolist() == [TILE, 0] and status.tolist() == [0, 2]


@pytest.mark.parametrize("name", ["unique", "duplicates", "heavy_s_run"])
def test_plain_k5_sums_match_jax_join_sums(name):
    """On the presorted narrow plan K5's per-tile key sums, summed, are both
    of the JAX join's sums (its input is the tensor K5 counts)."""
    r2d, skeys = sorted_case(name)
    s2d = jpb.prepare_probe_side(jnp.asarray(skeys), TILE)
    want = jpb._banded_join_device(r2d, s2d, jnp.asarray(skeys), tile=TILE,
                                   method="presorted", passes=0,
                                   max_chunks=16, unique_both=False,
                                   narrow=True, interpret=True)
    row_off, rows_needed = geometry(r2d, skeys)
    _, _, sums = banded_count_narrow(*port(r2d, s2d, row_off, rows_needed),
                                     tile=TILE)
    assert sums.dtype == torch.int64
    assert int(sums.sum()) == int(want[3]) == int(want[4])


MAXI32 = np.iinfo(np.int32).max
INT32_MIN = np.iinfo(np.int32).min


def register_case(kind):
    """(tile-sorted r2d, sorted skeys) for the register count's model at
    tile 2048, where the kernels hold 4 keys a thread (a warp 128 keys)."""
    rng = np.random.default_rng(21)
    n = 6 * TILE
    keys = np.arange(1, n + 1, dtype=np.int32)
    if kind == "runs_across_threads_and_warps":
        # runs of 1-11 copies start and end inside threads' 4 keys; one of
        # 300 copies spans a warp boundary (position 3 * 128)
        r = np.repeat(keys, rng.integers(1, 12, n))[:n]
        r[384 - 150:384 + 150] = r[384 - 150]
        s = np.sort(np.concatenate([np.arange(1, r.max() + 1), r[::3]]))
    elif kind == "run_in_the_overhang":
        # per tile, 20 copies of one key among the tile's last OV keys; S's
        # 257 copies of it straddle band position T (its end in the
        # overhang); 256 extra keys a tile keep the bands row-aligned
        r = keys.copy()
        extra = []
        for t in range(n // TILE):
            k = r[t * TILE + TILE - 100]
            r[t * TILE + TILE - 110:t * TILE + TILE - 90] = k
            extra.append(np.full(256, k, np.int32))
        s = np.sort(np.concatenate([keys] + extra))
    elif kind == "pack_limit_and_above":
        high = np.concatenate([(1 << 29) + np.arange(400), np.full(100,
                                                                   MAXI32 - 1)])
        r = np.sort(np.concatenate([keys[:n - 500], high])).astype(np.int32)
        s = np.sort(np.concatenate([r, high]))
    elif kind == "negatives_and_int32_min":
        r = np.sort(rng.integers(INT32_MIN, MAXI32, n)).astype(np.int32)
        r[:50] = INT32_MIN
        s = np.sort(np.concatenate([r[::2], np.full(30, INT32_MIN)]))
    elif kind == "s_run_of_6000":
        r = keys
        s = np.sort(np.concatenate([keys, np.full(6000, 100, np.int32)]))
    else:   # "padding_tile": the last tile MAXI32 only
        r, s = keys[:n - TILE], keys
    return jpb.to_tiles_2d(jnp.asarray(r.astype(np.int32)), TILE), \
        s.astype(np.int32)


@pytest.mark.parametrize("kind", ["runs_across_threads_and_warps",
                                  "run_in_the_overhang",
                                  "pack_limit_and_above",
                                  "negatives_and_int32_min", "s_run_of_6000",
                                  "padding_tile"])
def test_register_count_model_matches_plain(kind):
    """The kernels' count, thread by thread (4 keys a thread at tile 2048:
    one binary search, then galloping, a repeated key reusing the last
    count, the last OV keys' threads also over the overhang), equals the
    plain narrow count: counts, flags and key sums."""
    r2d, skeys = register_case(kind)
    s2d = jpb.prepare_probe_side(jnp.asarray(skeys), TILE)
    row_off, rows_needed = geometry(r2d, skeys)
    args = port(r2d, s2d, row_off, rows_needed)
    assert bcn.KERNEL_SHAPES[TILE][0] == 4
    model = bcn.model_narrow_count(*args, tile=TILE)
    want = bcn.banded_count_narrow_ref(*args, tile=TILE)
    for m, w in zip(model, want):
        assert torch.equal(m, w)
    if kind == "s_run_of_6000":
        assert want[1][0] == 1
    elif kind != "negatives_and_int32_min":
        assert not want[1].any()
    if kind == "run_in_the_overhang":
        # the overhang adds pairs: more than one per tile key below PACK_LIMIT
        assert int(want[0].sum()) > 20 * 256 * (r2d.shape[0] // RPT)


def test_register_count_model_reads_no_band_past_the_end():
    keys = torch.arange(1, 2 * TILE + 1, dtype=torch.int32)
    s_pad = tpb.prepare_probe_side(keys, TILE)
    row_off = torch.tensor([0, s_pad.numel() // 128 - 8], dtype=torch.int32)
    rows = torch.full((2,), RPT, dtype=torch.int32)
    counts, flags, sums = bcn.model_narrow_count(keys, s_pad, row_off, rows,
                                                 tile=TILE)
    assert counts.tolist() == [TILE, 0] and flags.tolist() == [0, 2]
    assert sums.tolist() == [TILE * (TILE + 1) // 2,
                             sum(range(TILE + 1, 2 * TILE + 1))]
