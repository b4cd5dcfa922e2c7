"""The Wisconsin multijoin of the port (``htm_hashjoin_tpu_torch.wisconsin``)
held to the JAX package's (``htm_hashjoin_tpu.wisconsin``) on the CPU, on
the same numpy inputs: hash functions, tables, every partitioner's layout,
the rotation-packed key-value split (K7's plain version against the Pallas
kv sort in interpret mode), the joiner lattice and its bounds routes, and
``run_multijoin`` on shared ``.npz`` tables.

Both packages take the stable split on the CPU, so layouts agree exactly
there.  Three faults of the reference are pinned where the port differs on
purpose: the local route's unbounded build pad (#2), the kv gate that
admits a string payload (#3) and the stale GSORT_KV_BITS comment (#4,
``tests/test_torch_sort_kv.py``).
"""

import json
import os
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from htm_hashjoin_tpu import wisconsin as J
from htm_hashjoin_tpu.relation import next_pow2
from htm_hashjoin_tpu.wisconsin import joiners as JJ
from htm_hashjoin_tpu.wisconsin import partitioner as JP
from htm_hashjoin_tpu_torch import wisconsin as P
from htm_hashjoin_tpu_torch.ops import global_sort_kv as gkv
from htm_hashjoin_tpu_torch.ops import multijoin_probe as MP
from htm_hashjoin_tpu_torch.wisconsin import joiners as PJ
from htm_hashjoin_tpu_torch.wisconsin import partitioner as PP
from htm_hashjoin_tpu_torch.wisconsin.driver import PORT_ONLY_FIELDS

CPU = torch.device("cpu")
CONF_DIR = os.path.join(os.path.dirname(__file__), "..",
                        "htm_hashjoin_tpu", "wisconsin", "conf")


def arr(x) -> np.ndarray:
    """A column or result of either package as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def same(got, want) -> None:
    """Equal values and the same dtype."""
    g, w = arr(got), arr(want)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def both_tables(cols, types=("long", "long"), page_size=256):
    """The same numpy columns as a table of each package."""
    out = []
    for pkg in (J, P):
        t = pkg.WriteTable(pkg.Schema.create(types), page_size)
        t.append_batch([np.asarray(c) for c in cols])
        t.finalize()
        out.append(t)
    return out


def pk_fk(n_r, n_s, seed, dtype=np.int32, zipf=None):
    """A primary-key build (keys a permutation of 1..n_r, rid 1..n_r) and a
    foreign-key probe (every key n_s/n_r times, shuffled; or zipf-skewed)."""
    rng = np.random.default_rng(seed)
    bkeys = rng.permutation(np.arange(1, n_r + 1))
    if zipf is None:
        pkeys = rng.permutation(np.tile(np.arange(1, n_r + 1),
                                        -(-n_s // n_r))[:n_s])
    else:
        pkeys = np.minimum(rng.zipf(zipf, n_s), n_r)
    build = [bkeys.astype(dtype), np.arange(1, n_r + 1, dtype=dtype)]
    probe = [pkeys.astype(dtype), np.arange(1, n_s + 1, dtype=dtype)]
    return both_tables(build), both_tables(probe)


# ---------------------------------------------------------------------------
# hash functions
# ---------------------------------------------------------------------------

HASHES = [("range", 1, 1024, 4, 0), ("range", -50, 3000, 7, 0),
          ("modulo", 1, 16777216, 2048, 12), ("modulo", 0, 100, 1000, 0),
          ("modulo", 1, 16777216, 64, 17), ("modulo", -5, 1 << 40, 64, 30),
          ("magic", 0, 1 << 20, 4096, 0)]


def both_hashes(fn, vmin, vmax, k, skip):
    node = {"fn": fn, "range": [vmin, vmax], "buckets": k, "skipbits": skip}
    return J.hash_factory(node), P.hash_factory(node)


@pytest.mark.parametrize("spec", HASHES)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_hash_values_match_jax(spec, dtype):
    jh, ph = both_hashes(*spec)
    rng = np.random.default_rng(3)
    vals = rng.integers(max(spec[1], -1000), min(spec[2], 1 << 30),
                        5000).astype(dtype)
    same(ph.hash(torch.from_numpy(vals)), jh.hash(jnp.asarray(vals)))
    assert ph.buckets == jh.buckets
    assert ph.fingerprint() == jh.fingerprint()
    assert ph == P.hash_factory({"fn": spec[0], "range": list(spec[1:3]),
                                 "buckets": spec[3], "skipbits": spec[4]})


@pytest.mark.parametrize("passes", [1, 2, 3, 4])
def test_modulo_generate_matches_jax(passes):
    jh = J.ModuloHash(0, 1 << 24, 1 << 12, skipbits=3)
    ph = P.ModuloHash(0, 1 << 24, 1 << 12, skipbits=3)
    vals = np.random.default_rng(passes).integers(0, 1 << 24, 3000)
    jfns, pfns = jh.generate(passes), ph.generate(passes)
    assert [(f._mask, f._skipbits, f.buckets) for f in pfns] == \
        [(f._mask, f._skipbits, f.buckets) for f in jfns]
    for jf, pf in zip(jfns, pfns):
        same(pf.hash(torch.from_numpy(vals)), jf.hash(jnp.asarray(vals)))


def test_hash_factory_rejects_unknown():
    with pytest.raises(ValueError):
        P.hash_factory({"fn": "crc", "range": [0, 1], "buckets": 2})


# ---------------------------------------------------------------------------
# tables, conf generation and datagen copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,alphabet,zipf", [(1000, 1000, 0.0),
                                                (4000, 1000, 0.0),
                                                (5000, 1000, 0.99)])
def test_generate_narrows_like_jax(size, alphabet, zipf):
    pt = P.WriteTable(P.Schema.create(("long", "long")))
    pt.generate(size, alphabet, zipf, 7)
    jt = J.WriteTable(J.Schema.create(("long", "long")))
    jt.generate(size, alphabet, zipf, 7)
    for i in (1, 2):
        assert arr(pt.column(i)).dtype == arr(jt.column(i)).dtype == np.int32
    same(pt.column(2), jt.column(2))
    keys = arr(pt.column(1))
    assert keys.min() >= 1 and keys.max() <= alphabet
    if zipf == 0.0:      # pk / fk: the same key multiset (different shuffle)
        np.testing.assert_array_equal(np.sort(keys),
                                      np.sort(arr(jt.column(1))))
    else:
        assert np.bincount(keys).max() > 25


def test_string_key_and_payload_generate_like_jax():
    pt = P.WriteTable(P.Schema.create(("string", "string", "double")))
    pt.generate(64, 64, 0.0, 1)
    jt = J.WriteTable(J.Schema.create(("string", "string", "double")))
    jt.generate(64, 64, 0.0, 1)
    assert sorted(pt.column(1)) == sorted(jt.column(1))
    np.testing.assert_array_equal(pt.column(2), jt.column(2))
    same(pt.column(3), jt.column(3))


@pytest.mark.parametrize("ext", [".tbl", ".npz"])
def test_save_load_across_packages(tmp_path, ext):
    (jb, pb), _ = pk_fk(300, 300, 1)
    for src, dst_pkg, name in ((pb, J, "p"), (jb, P, "j")):
        path = str(tmp_path / f"{name}{ext}")
        src.save(path)
        dst = dst_pkg.WriteTable(dst_pkg.Schema.create(("long", "long")))
        dst.load(path)
        for i in (1, 2):
            np.testing.assert_array_equal(arr(dst.column(i)),
                                          arr(src.column(i)))


def test_load_bz2_and_strings(tmp_path):
    import bz2
    p = tmp_path / "t.tbl.bz2"
    with bz2.open(p, "wt") as f:
        for i in range(1, 101):
            f.write(f"{i}|name{i}\n")
    tables = [pkg.WriteTable(pkg.Schema.create(["long", "string"]))
              for pkg in (J, P)]
    for t in tables:
        t.load(str(p))
    same(tables[1].column(1), tables[0].column(1))
    np.testing.assert_array_equal(tables[1].column(2), tables[0].column(2))


def test_split_gather_checksum_like_jax():
    (jb, pb), _ = pk_fk(1000, 1000, 2)
    jb.page_size = pb.page_size = 100
    for a, b in zip(pb.split(3), jb.split(3)):
        np.testing.assert_array_equal(a, b)
    rows = np.array([5, 1, 999, 0])
    for i in (1, 2):
        same(pb.gather(rows).column(i), jb.gather(rows).column(i))
    assert pb.checksum(1) == jb.checksum(1) == 500500


def test_confgen_and_datagen_copies_match():
    for algo, e, kw in (("parallel", 11, {"threads": 12}),
                        ("radix", 6, {"passes": 2, "steal": True}),
                        ("independent", 3, {})):
        assert P.render_conf(algo, e, **kw) == J.render_conf(algo, e, **kw)
    np.testing.assert_array_equal(P.build_rows(64), J.build_rows(64))
    np.testing.assert_array_equal(P.probe_rows(64, copies=4, seed=1),
                                  J.probe_rows(64, copies=4, seed=1))
    for name in ("steal.conf", "flatmem.conf"):
        path = os.path.join(CONF_DIR, name)
        assert P.parse_conf(path) == J.parse_conf(path)


def test_sync_stats_matches_jax():
    from htm_hashjoin_tpu.utils.profiler import sync_stats as jss
    from htm_hashjoin_tpu_torch.utils.profiler import sync_stats
    for w in ([3.0, 1.0, 2.0], [], [0.0, 0.0], [5.5]):
        assert sync_stats(w) == jss(w)


# ---------------------------------------------------------------------------
# partitioners
# ---------------------------------------------------------------------------

def split_inputs(payload, seed=4, n=3000):
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 4097, n)
    if payload == "string":
        return both_tables([keys.astype(np.int32),
                            np.array([f"r{i}" for i in range(n)], object)],
                           types=("long", "string"))
    dtype = np.int32 if payload == "int32" else np.int64
    return both_tables([keys.astype(dtype),
                        rng.integers(-2**31, 2**31 - 1, n).astype(dtype)])


def assert_same_split(pr, jr):
    same(pr.sizes, jr.sizes)
    same(pr.offsets, jr.offsets)
    for pc, jc in zip(pr.table.columns, jr.table.columns):
        if isinstance(jc, np.ndarray) and jc.dtype == object:
            np.testing.assert_array_equal(pc, jc)
        else:
            same(pc, jc)
    np.testing.assert_array_equal(arr(pr.perm), arr(jr.perm))


@pytest.mark.parametrize("algo", ["no", "parallel", "independent", "derek",
                                  "radix"])
@pytest.mark.parametrize("payload", ["int32", "int64", "string"])
def test_partitioner_layout_matches_jax(algo, payload):
    jt, pt = split_inputs(payload)
    node = {"algorithm": algo, "pagesize": 256, "attribute": 1, "passes": 2}
    hash_node = {"fn": "modulo", "range": [1, 4096], "buckets": 16,
                 "skipbits": 3}
    jp = J.partitioner_factory(node, hash_node, 4)
    pp = P.partitioner_factory(node, hash_node, 4)
    assert type(pp).__name__ == type(jp).__name__
    jr, pr = jp.split(jt), pp.split(pt)
    assert_same_split(pr, jr)
    assert pr.nparts == jr.nparts
    assert (pr.part_hash is None) == (jr.part_hash is None)
    if algo == "radix":
        same(pp.histogram, jp.histogram)
        assert [f.fingerprint() for f in pp.pass_fns] == \
            [f.fingerprint() for f in jp.pass_fns]


def test_partitioner_factory_rejects_unknown():
    with pytest.raises(ValueError):
        P.partitioner_factory({"algorithm": "hyper"}, {}, 1)


def rot2_inputs(bias: bool):
    """The shapes of tests/test_wisconsin.py's rotation kv split tests."""
    rng = np.random.default_rng(13 if bias else 9)
    n = 6000 if bias else 5000
    keys = rng.integers(1, 1 << 14, n).astype(np.int32)
    payload = (np.arange(n, dtype=np.int32) if bias
               else rng.integers(0, 1 << 30, n).astype(np.int32))
    shard = ((np.arange(n) // 64) % 8).astype(np.int32)
    restbits = max(int(keys.max()).bit_length() - 4, 0)
    return keys, payload, shard, restbits


@pytest.mark.parametrize("bias", [False, True])
def test_rotation_kv_split_matches_jax(bias):
    keys, payload, shard, restbits = rot2_inputs(bias)
    kw = dict(bias_bits=3) if bias else {}
    j_key, j_pay, j_so = JP._reorder_rot2_kv(
        jnp.asarray(keys), jnp.asarray(payload), J.ModuloHash(1, 1 << 14, 16),
        16, 1, 0, 4, restbits, bias=jnp.asarray(shard) if bias else None,
        interpret=True, **kw)
    before = gkv.LAUNCHES
    p_key, p_pay, p_so = PP._reorder_rot2_kv(
        torch.from_numpy(keys), torch.from_numpy(payload),
        P.ModuloHash(1, 1 << 14, 16), 16, 1, 0, 4, restbits,
        bias=torch.from_numpy(shard) if bias else None, **kw)
    assert gkv.LAUNCHES == before
    same(p_so, j_so)                      # sizes and offsets, exactly
    same(p_key, j_key)                    # keys in each partition, exactly
    pairs = [np.sort((arr(k).astype(np.int64) << 32) | arr(v))
             for k, v in ((p_key, p_pay), (j_key, j_pay))]
    np.testing.assert_array_equal(*pairs)   # payload multiset per key
    if bias:    # shards stay contiguous inside each partition
        for p in range(16):
            seg = slice(int(p_so[1][p]), int(p_so[1][p] + p_so[0][p]))
            shards = shard[arr(p_pay)[seg]]
            assert np.all(np.diff(shards) >= 0)


def open_kv_gate(monkeypatch, min_rows=1024):
    """Let CPU tensors take the kv split (the card's route) and count the
    calls that take it."""
    calls = []
    orig = PP._reorder_rot2_kv
    monkeypatch.setattr(PP, "_on_card", lambda keys: True)
    monkeypatch.setattr(PP, "KV_MIN_ROWS", min_rows)
    monkeypatch.setattr(PP, "_reorder_rot2_kv",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


@pytest.mark.parametrize("algo", ["parallel", "independent", "radix"])
def test_kv_route_groups_like_the_stable_split(monkeypatch, algo):
    """The card's route, taken here through the plain K7: the same sizes
    and offsets as JAX's stable CPU split, the same (key, payload) multiset
    in every partition, key-ordered inside it."""
    calls = open_kv_gate(monkeypatch)
    jt, pt = split_inputs("int32")
    node = {"algorithm": algo, "pagesize": 256, "attribute": 1}
    hash_node = {"fn": "modulo", "range": [1, 4096], "buckets": 16,
                 "skipbits": 3}
    pr = P.partitioner_factory(node, hash_node, 4).split(pt)
    jr = J.partitioner_factory(node, hash_node, 4).split(jt)
    assert calls == [1]
    same(pr.sizes, jr.sizes)
    same(pr.offsets, jr.offsets)
    for p in range(16):
        seg = slice(int(pr.offsets[p]), int(pr.offsets[p] + pr.sizes[p]))
        got = [arr(c)[seg].astype(np.int64) for c in pr.table.columns]
        want = [arr(c)[seg].astype(np.int64) for c in jr.table.columns]
        np.testing.assert_array_equal(
            np.sort((got[0] << 32) | (got[1] & 0xFFFFFFFF)),
            np.sort((want[0] << 32) | (want[1] & 0xFFFFFFFF)))
        if algo != "independent":
            assert np.all(np.diff(got[0]) >= 0)
    assert sorted(arr(pr.perm).tolist()) == list(range(3000))


def test_string_payload_takes_the_stable_split(monkeypatch):
    """Reference fault #3: the JAX kv gate (partitioner.py:236-241) admits
    a two-column table with a string payload, which then fails on the TPU.
    The port requires two numeric columns: with the kv route open, such a
    table splits on the stable path, equal to JAX's CPU split."""
    calls = open_kv_gate(monkeypatch)
    jt, pt = split_inputs("string")
    h = {"fn": "modulo", "range": [1, 4096], "buckets": 16, "skipbits": 3}
    for algo in ("parallel", "independent"):
        node = {"algorithm": algo, "pagesize": 256, "attribute": 1}
        pr = P.partitioner_factory(node, h, 4).split(pt)
        jr = J.partitioner_factory(node, h, 4).split(jt)
        assert_same_split(pr, jr)
    assert calls == []


def test_kv_gate_falls_back_past_its_certificate(monkeypatch):
    """Keys below the hash's range minimum void the packing certificate
    (partitioner.py:249-259): the stable path runs, equal to JAX's."""
    calls = open_kv_gate(monkeypatch)
    rng = np.random.default_rng(5)
    cols = [rng.integers(-20, 4097, 3000).astype(np.int32),
            np.arange(3000, dtype=np.int32)]
    jt, pt = both_tables(cols)
    h = {"fn": "modulo", "range": [1, 4096], "buckets": 16}
    node = {"algorithm": "parallel", "attribute": 1}
    assert_same_split(P.partitioner_factory(node, h, 1).split(pt),
                      J.partitioner_factory(node, h, 1).split(jt))
    assert calls == []


@pytest.mark.parametrize("algo", ["parallel", "independent", "radix"])
def test_kv_route_makes_no_bucket_shard_or_rank_column(monkeypatch, algo):
    """The kv gate is decided before the stable path's columns: with the
    kv route open, the bucket hash and the rank sort never run (both raise
    here), and the split still equals JAX's stable split in sizes and
    offsets."""
    calls = open_kv_gate(monkeypatch)

    def never(*args, **kw):
        raise AssertionError("the kv route made a stable-path column")
    monkeypatch.setattr(P.ModuloHash, "hash", never)
    monkeypatch.setattr(PP, "_reorder_device_packed2", never)
    jt, pt = split_inputs("int32")
    node = {"algorithm": algo, "pagesize": 256, "attribute": 1}
    hash_node = {"fn": "modulo", "range": [1, 4096], "buckets": 16,
                 "skipbits": 3}
    pr = P.partitioner_factory(node, hash_node, 4).split(pt)
    jr = J.partitioner_factory(node, hash_node, 4).split(jt)
    assert calls == [1]
    same(pr.sizes, jr.sizes)
    same(pr.offsets, jr.offsets)


def test_kv_route_counts_no_kernel_split_on_the_cpu(monkeypatch, tmp_path):
    """``kvSplits`` counts the splits that ran the packing kernels and K7:
    with the kv route open on the CPU both splits take it, through the
    plain versions, and the line reads 0, its keys and values JAX's."""
    calls = open_kv_gate(monkeypatch)
    write_npz(tmp_path, np.int32, False)
    p_res = P.run_multijoin(npz_conf("independent"),
                            base_path=str(tmp_path), device=CPU)
    j_res = J.run_multijoin(npz_conf("independent"),
                            base_path=str(tmp_path))
    assert calls == [1, 1]
    assert p_res.fields["kvSplits"] == 0
    assert_same_line(p_res, j_res)
    np.testing.assert_array_equal(row_multiset(p_res.output),
                                  row_multiset(j_res.output))


# ---------------------------------------------------------------------------
# bounds kernels and worker-block programs
# ---------------------------------------------------------------------------

def test_match_bounds_match_jax():
    rng = np.random.default_rng(7)
    build = np.sort(rng.integers(0, 500, size=1024)).astype(np.int32)
    probe = rng.integers(-1, 600, size=2048).astype(np.int32)
    for dt_j, dt_p in ((jnp.int32, torch.int32), (jnp.int64, torch.int64)):
        j = JJ._match_bounds_tagged(jnp.asarray(build), jnp.asarray(probe),
                                    dt_j)
        p = PJ._match_bounds_tagged(torch.from_numpy(build),
                                    torch.from_numpy(probe), dt_p)
        for a, b in zip(p, j):
            same(a, b)
    wide = probe.astype(np.int64) + (1 << 40)
    j = JJ._match_bounds(jnp.asarray(build.astype(np.int64)),
                         jnp.asarray(wide))
    p = PJ._match_bounds(torch.from_numpy(build.astype(np.int64)),
                         torch.from_numpy(wide))
    for a, b in zip(p, j):
        same(a, b)


@pytest.mark.parametrize("cap_extra", [0, 37])
def test_expand_matches_match_jax(cap_extra):
    rng = np.random.default_rng(cap_extra)
    lo = rng.integers(0, 100, 300).astype(np.int32)
    cnt = rng.integers(0, 4, 300).astype(np.int32)
    cnt[:5] = 0                       # empty ranges at the start and inside
    cnt[100:120] = 0
    hi = lo + cnt
    cap = next_pow2(int(cnt.sum())) + cap_extra
    j = JJ._expand_matches(jnp.asarray(lo), jnp.asarray(hi), cap)
    p = PJ._expand_matches(torch.from_numpy(lo), torch.from_numpy(hi), cap)
    same(p[0], j[0])
    same(p[1], j[1])
    assert p[2] == int(j[2])


def test_dense_and_flat_directories_match_jax():
    rng = np.random.default_rng(11)
    build = rng.integers(0, 300, size=512).astype(np.int32)
    probe = rng.integers(-5, 400, size=1024).astype(np.int32)
    tbl_len = next_pow2(302)
    j_cum, j_cnt, j_mx = JJ._dense_rank_table(
        jnp.asarray(build), jnp.zeros((tbl_len,), jnp.int32))
    p_cum, p_cnt, p_mx = PJ._dense_rank_table(torch.from_numpy(build),
                                              tbl_len)
    same(p_cum, j_cum)
    same(p_cnt, j_cnt)
    assert int(p_mx) == int(j_mx)
    for p, j in zip(PJ._dense_bounds(p_cum, p_cnt, torch.from_numpy(probe)),
                    JJ._dense_bounds(j_cum, j_cnt, jnp.asarray(probe))):
        same(p, j)
    order = np.argsort(build, kind="stable")
    j_dir = JJ._flat_directory(jnp.asarray(build[order]),
                               jnp.zeros((tbl_len,), jnp.int32))
    p_dir = PJ._flat_directory(torch.from_numpy(build[order]), tbl_len)
    for p, j in zip(p_dir, j_dir):
        same(p, j)
    for p, j in zip(PJ._flat_dense_bounds(*p_dir, torch.from_numpy(probe)),
                    JJ._flat_dense_bounds(*j_dir, jnp.asarray(probe))):
        same(p, j)


def test_perm_bounds_match_jax():
    rng = np.random.default_rng(3)
    probe = np.concatenate([rng.integers(5, 517, size=777),
                            [9999, -1]]).astype(np.int32)
    for sl in (slice(0, 777), slice(None)):
        p = PJ._dense_bounds_perm(torch.from_numpy(probe[sl]), 5, 516)
        j = JJ._dense_bounds_perm(jnp.asarray(probe[sl]), 5, 516)
        for a, b in zip(p, j):
            same(a, b)


@pytest.mark.parametrize("use_i32", [False, True])
def test_steal_cuts_match_jax(use_i32):
    rng = np.random.default_rng(5)
    occ = rng.integers(0, 7, 1 << 12).astype(np.int32)
    buckets = rng.integers(0, 1 << 12, 20000).astype(np.int32)
    p = PJ._steal_cuts(torch.from_numpy(occ), torch.from_numpy(buckets), 8,
                       use_i32)
    j = JJ._steal_cuts(jnp.asarray(occ), jnp.asarray(buckets), 8, use_i32)
    for a, b in zip(p, j):
        same(a, b)


def test_count_into_matches_jax_drop_scatter():
    idx = np.array([0, 3, 3, -1, -8, -9, 8, 100, 7], np.int32)
    want = jnp.zeros((8,), jnp.int32).at[jnp.asarray(idx)].add(
        1, mode="drop")
    same(PJ._count_into(8, torch.from_numpy(idx)), want)


def test_part_sorted_build_and_unit_blocks_match_jax():
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 50, 400).astype(np.int32)
    sizes = np.array([0, 120, 0, 200, 80, 0], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    j = JJ._part_sorted_build(jnp.asarray(keys), len(sizes),
                              jnp.asarray(offsets))
    p = PJ._part_sorted_build(torch.from_numpy(keys),
                              torch.from_numpy(offsets))
    for a, b in zip(p, j):
        same(a, b)
    units = [(0, 5), (5, 9), (9, 30), (30, 31), (31, 60), (60, 64)]
    for k in (1, 2, 4, 8):
        assert PJ._balance_unit_blocks(units, k) == \
            JJ._balance_unit_blocks(units, k)


# ---------------------------------------------------------------------------
# the joiner lattice
# ---------------------------------------------------------------------------

def assert_same_join(p_out, j_out, p_joiner, j_joiner):
    assert p_out.num_rows == j_out.num_rows
    for i in range(1, len(j_out.columns) + 1):
        jc = j_out.column(i)
        if isinstance(jc, np.ndarray) and jc.dtype == object:
            np.testing.assert_array_equal(p_out.column(i), jc)
        else:
            same(p_out.column(i), jc)
    ps, js = p_joiner.stats, j_joiner.stats
    for f in ("build_rows", "probe_rows", "output_rows", "bucket_count",
              "max_bucket_occupancy"):
        assert getattr(ps, f) == getattr(js, f), f
    for f in ("partition_probe_costs", "stolen_balance"):
        if getattr(js, f) is None:
            assert getattr(ps, f) is None
        else:
            same(getattr(ps, f), getattr(js, f))
    if js.probe_schedule is None:
        assert ps.probe_schedule is None
    else:
        for f in ("policy", "route"):
            assert ps.probe_schedule[f] == js.probe_schedule[f]
        assert [u[:2] for u in ps.probe_schedule["units"]] == \
            [u[:2] for u in js.probe_schedule["units"]]
        assert len(ps.probe_schedule["worker_micros"]) == \
            len(js.probe_schedule["worker_micros"])
        assert all(u[2] >= 0 for u in ps.probe_schedule["units"])


def run_both(build, probe, joiner_kw, part_b=None, part_p=None,
             hash_args=(1, 512, 64), sel=([2], [2])):
    """Build + probe with the same joiner and partitioners in both
    packages; part_b/part_p are (hash args) of a ParallelPartitioner, or
    None for no split."""
    results = []
    for pkg, (tb, tp) in ((P, (build[1], probe[1])),
                          (J, (build[0], probe[0]))):
        joiner = pkg.HashJoiner(pkg.ModuloHash(*hash_args), **joiner_kw)
        joiner.init(tb.schema, sel[0], 1, tp.schema, sel[1], 1)

        def split(t, part):
            if part is None:
                return pkg.NoPartitioner().split(t)
            return pkg.ParallelPartitioner(pkg.ModuloHash(*part)).split(t)
        joiner.build(split(tb, part_b))
        results.append((joiner.probe(split(tp, part_p)), joiner))
    (p_out, p_j), (j_out, j_j) = results
    assert_same_join(p_out, j_out, p_j, j_j)
    return p_out, p_j, j_j


LATTICE = [(s, b, p) for s in ("copy", "pointer")
           for b in (False, True) for p in (False, True)]


@pytest.mark.parametrize("storage,pbuild,pprobe", LATTICE)
def test_lattice_point_matches_jax(storage, pbuild, pprobe):
    build, probe = pk_fk(512, 2048, 11)
    out, pj, _ = run_both(build, probe,
                          dict(storage=storage, partition_build=pbuild,
                               partition_probe=pprobe, nthreads=4),
                          part_b=(1, 512, 16) if pbuild else None,
                          part_p=(1, 512, 16) if pprobe else None)
    assert out.num_rows == 2048
    if pprobe:
        assert pj.stats.probe_schedule["route"] == "perm"


@pytest.mark.parametrize("zipf", [None, 1.05])
def test_probe_steal_matches_jax(zipf):
    build, probe = pk_fk(512, 4096, 22, zipf=zipf)
    out, pj, _ = run_both(build, probe, dict(steal=True, nthreads=4),
                          part_p=(1, 512, 8))
    assert out.num_rows == 4096
    assert pj.stats.probe_schedule["policy"] == "probe_steal"


def dup_tables(seed=6, n_r=512, n_s=2048, lo=1, hi=300):
    rng = np.random.default_rng(seed)
    build = [rng.integers(lo, hi, n_r).astype(np.int32),
             np.arange(1, n_r + 1, dtype=np.int32)]
    probe = [rng.integers(lo - 5, hi + 50, n_s).astype(np.int32),
             np.arange(1, n_s + 1, dtype=np.int32)]
    return both_tables(build), both_tables(probe)


@pytest.mark.parametrize("pprobe", [False, True])
def test_dense_route_with_duplicate_build_keys_matches_jax(pprobe):
    build, probe = dup_tables()
    out, pj, _ = run_both(build, probe,
                          dict(partition_build=True, partition_probe=pprobe,
                               nthreads=4),
                          part_b=(1, 512, 16),
                          part_p=(1, 512, 16) if pprobe else None)
    assert out.num_rows > 2048      # duplicates: the general expansion
    if pprobe:
        assert pj.stats.probe_schedule["route"] == "dense"


def wide_tables(base, skew=False):
    """tests/test_wisconsin.py's wide-key tables (keys beyond the dense
    limit, duplicates on both sides); ``skew`` puts almost every build row
    into one partition of a 16-way ModuloHash."""
    rng = np.random.default_rng(42)
    step = 16 * 37 if skew else 37
    bkeys = base + rng.integers(0, 4096, size=2000) * step
    if skew:
        bkeys[:20] = base + 1 + np.arange(20)
    else:
        bkeys[:100] = bkeys[100:200]
    pkeys = base + rng.integers(0, 4096, size=6000) * 37
    build = [bkeys.astype(np.int64), np.arange(2000, dtype=np.int64)]
    probe = [pkeys.astype(np.int64), np.arange(6000, dtype=np.int64)]
    return both_tables(build), both_tables(probe)


@pytest.mark.parametrize("base", [1 << 26, 1 << 30])
@pytest.mark.parametrize("same_hash", [True, False])
def test_local_and_sorted_routes_match_jax(base, same_hash):
    build, probe = wide_tables(base)
    out, pj, _ = run_both(build, probe,
                          dict(partition_build=True, partition_probe=True,
                               nthreads=4),
                          part_b=(1, 1 << 32, 16),
                          part_p=(1, 1 << 32, 16 if same_hash else 8),
                          hash_args=(1, 1 << 32, 4096))
    assert pj.stats.probe_schedule["route"] == \
        ("local" if same_hash else "sorted")
    assert out.num_rows > 0


def test_skewed_build_partition_routes_sorted(monkeypatch):
    """Reference fault #2: the JAX local-route gate (joiners.py:753-757)
    bounds only the probe pad, so one skewed build partition makes a
    (units, next_pow2(that partition)) build matrix of any size.  The port
    bounds both and takes "sorted" when the build pad is over its limit
    (lowered here so that the CPU test stays small); the answer is JAX's,
    which takes "local"."""
    build, probe = wide_tables(1 << 26, skew=True)
    sizes = np.bincount((build[1].column(1).numpy() - 1) & 15, minlength=16)
    n_units, max_part = 16, int(sizes.max())
    assert max_part > 1900           # one partition holds the build
    limit = n_units * next_pow2(max_part) - 1
    monkeypatch.setattr(PJ, "_LOCAL_PAD_LIMIT", limit)
    results = []
    for pkg, (tb, tp) in ((P, (build[1], probe[1])),
                          (J, (build[0], probe[0]))):
        joiner = pkg.HashJoiner(pkg.ModuloHash(1, 1 << 32, 4096),
                                partition_build=True, partition_probe=True,
                                nthreads=4)
        joiner.init(tb.schema, [2], 1, tp.schema, [2], 1)
        part = pkg.ParallelPartitioner(pkg.ModuloHash(1, 1 << 32, 16))
        joiner.build(part.split(tb))
        results.append((joiner.probe(part.split(tp)), joiner))
    (p_out, pj), (j_out, jj) = results
    assert pj.stats.probe_schedule["route"] == "sorted"
    assert jj.stats.probe_schedule["route"] == "local"
    assert p_out.num_rows == j_out.num_rows > 0
    for i in (1, 2):
        same(p_out.column(i), j_out.column(i))


# ---------------------------------------------------------------------------
# the probe kernel's route (ops/multijoin_probe.py), its plain version here
# ---------------------------------------------------------------------------

def open_probe_gate(monkeypatch):
    """Let CPU tensors take the probe kernel's route (the card's), through
    the plain version, and count the blocks handed to it."""
    calls = []
    orig = PJ.multijoin_probe
    monkeypatch.setattr(PJ, "_on_card", lambda keys: True)
    monkeypatch.setattr(PJ, "multijoin_probe",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


def run_routes(monkeypatch, build, probe, joiner_kw, part=(1, 512, 16),
               hash_args=(1, 512, 64)):
    """The same join through the port's torch route (the gate shut), the
    probe kernel's route (the gate open) and JAX's joiner.  The open route
    equals JAX's in its output, stats and schedule, and the torch route in
    every output value, the capacity's tail included.  Returns the open
    route's output, joiner, the blocks handed to the route and the blocks
    it kept (``PROBE_KERNEL_BLOCKS``)."""
    p_out, p_j, j_j = run_both(build, probe, joiner_kw, part_b=part,
                               part_p=part, hash_args=hash_args)
    calls = open_probe_gate(monkeypatch)
    kept = PJ.PROBE_KERNEL_BLOCKS
    o_out, o_j, _ = run_both(build, probe, joiner_kw, part_b=part,
                             part_p=part, hash_args=hash_args)
    kept = PJ.PROBE_KERNEL_BLOCKS - kept
    assert len(o_out.columns) == len(p_out.columns)
    for got, want in zip(o_out.columns, p_out.columns):
        same(got, want)
    same(o_j.stats.partition_probe_costs, p_j.stats.partition_probe_costs)
    same(o_j._last_unit_totals, p_j._last_unit_totals)
    return o_out, o_j, len(calls), kept


@pytest.mark.parametrize("n_s", [2048, 2047, 1000, 5])
def test_probe_kernel_route_matches_the_torch_emit_and_jax(monkeypatch, n_s):
    """A ProbeIsPart probe of a permutation build: every worker block
    takes the route, the emit is skipped, and the output (with the torch
    emit's tail past a ragged n), the unit totals, the partition costs and
    the schedule equal the torch route's and JAX's."""
    build, probe = pk_fk(512, n_s, 11)
    out, pj, calls, kept = run_routes(
        monkeypatch, build, probe,
        dict(partition_build=True, partition_probe=True, nthreads=4))
    sched = pj.stats.probe_schedule
    assert (sched["policy"], sched["route"]) == ("probe_is_part", "perm")
    blocks = len(PJ._balance_unit_blocks(
        [(a, a + n) for a, n, _ in sched["units"]], 4))
    assert calls == kept == blocks == min(4, len(sched["units"]))
    assert out.num_rows == n_s
    assert out.columns[0].numel() == max(8, next_pow2(n_s))
    assert int(pj._last_unit_totals.sum()) == n_s


def test_probe_key_outside_the_build_takes_the_torch_route(monkeypatch):
    """A probe key past kmax voids the certificate in its block's head:
    the route's output is dropped, none of its blocks counts, and the
    torch route runs from the start, equal to JAX's."""
    build, probe = pk_fk(512, 2048, 12)
    cols = [probe[0].column(1).copy(), probe[0].column(2)]
    cols[0][[7, 1500]] = [600, 513]
    probe = both_tables(cols)
    out, pj, calls, kept = run_routes(
        monkeypatch, build, probe,
        dict(partition_build=True, partition_probe=True, nthreads=4))
    assert calls == 4 and kept == 0
    assert out.num_rows == 2046
    assert pj.stats.probe_schedule["route"] == "perm"


def test_negative_probe_keys_do_not_void_the_heads():
    """A key < 0 matches nothing and does not void the all-unit flag (the
    schedule's padding): the route's heads equal ``_block_bounds_perm``'s
    over the torch route's padded window, block by block."""
    rng = np.random.default_rng(4)
    keys = rng.integers(5, 517, 3000).astype(np.int32)
    keys[[3, 900, 2999]] = [-1, -7, -(1 << 30) + 1]
    units = [(0, 700), (700, 1500), (1500, 1501), (1501, 3000)]
    blocks = PJ._balance_unit_blocks(units, 2)
    U = max(b - a for a, b in blocks)
    W = next_pow2(3000)
    pk = torch.from_numpy(keys)
    pk_pad = torch.cat([pk, pk.new_full((W,), -1)])
    payload = torch.arange(512, dtype=torch.int32) * 3
    col = torch.arange(3000, dtype=torch.int32)
    out_b, out_p = torch.empty_like(col), torch.empty_like(col)
    heads = MP.new_heads(len(blocks), U, CPU)
    for b, (ulo, uhi) in enumerate(blocks):
        a0, ub = PJ._block_ubounds(units, ulo, uhi, U)
        ub = torch.from_numpy(ub)
        MP.multijoin_probe(pk, col, payload, 5, 516, a0, int(ub[-1]), ub,
                           out_b, out_p, heads[b])
        lo, _, want = PJ._block_bounds_perm(W, pk_pad, a0, ub, 5, 516)
        got = heads[b]
        same(got[:U], want[:U])
        assert int(got[U + 1]) == int(want[U + 1]) == 1
        rows = slice(a0, a0 + int(ub[-1]))
        same(out_b[rows], payload[lo[:int(ub[-1])]])
    assert int(heads[:, U].sum()) == 2997
    same(out_p, col)


def port_join(build, probe, part=(1, 512, 16)):
    """The port's ProbeIsPart join of a build and a probe table."""
    joiner = P.HashJoiner(P.ModuloHash(1, 512, 64), partition_build=True,
                          partition_probe=True, nthreads=4)
    joiner.init(build.schema, [2], 1, probe.schema, [2], 1)
    split = P.ParallelPartitioner(P.ModuloHash(*part)).split
    joiner.build(split(build))
    return joiner.probe(split(probe)), joiner


def test_an_empty_probe_takes_no_block(monkeypatch):
    """Reference fault #10: JAX's emit gathers the empty probe column at
    index 0 and raises.  The port returns an empty output, on the route's
    gate open or shut, and no block takes the route."""
    build, _ = pk_fk(512, 8, 13)
    empty = both_tables([np.zeros(0, np.int32), np.zeros(0, np.int32)])
    j = J.HashJoiner(J.ModuloHash(1, 512, 64), partition_build=True,
                     partition_probe=True, nthreads=4)
    j.init(build[0].schema, [2], 1, empty[0].schema, [2], 1)
    j_split = J.ParallelPartitioner(J.ModuloHash(1, 512, 16)).split
    j.build(j_split(build[0]))
    with pytest.raises(TypeError, match="out of range"):
        j.probe(j_split(empty[0]))
    shut, _ = port_join(build[1], empty[1])
    calls = open_probe_gate(monkeypatch)
    out, pj = port_join(build[1], empty[1])
    assert calls == [] and out.num_rows == shut.num_rows == 0
    assert pj.stats.output_rows == 0
    for got, want in zip(out.columns, shut.columns):
        same(got, want)


def test_negative_probe_keys_match_nothing_on_either_route(monkeypatch):
    """Reference fault #11: a negative probe key keeps the all-unit flag
    (it is the schedule's padding), so JAX's identity emit pairs the rows
    in order and cuts the last ones off (or raises where the count's
    capacity is below the probe's).  The port takes the identity only where
    every row matched: on the torch route and, through its fallback, on
    the kernel's, the output is the exact join."""
    build, probe = pk_fk(512, 2048, 16)
    keys = probe[1].column(1).numpy().copy()
    keys[[0, 5, 2047]] = [-1, -3, -(1 << 20)]
    probe = both_tables([keys, np.arange(1, 2049, dtype=np.int32)])
    rid_of_key = np.zeros(513, np.int64)
    rid_of_key[build[1].column(1).numpy()] = build[1].column(2).numpy()
    hit = keys > 0
    want = np.sort((rid_of_key[keys[hit]] << 32)
                   | np.arange(1, 2049)[hit])
    shut, _ = port_join(build[1], probe[1])
    calls = open_probe_gate(monkeypatch)
    out, pj = port_join(build[1], probe[1])
    assert len(calls) == 4 and pj.stats.probe_schedule["route"] == "perm"
    for res in (shut, out):
        assert res.num_rows == 2045
        np.testing.assert_array_equal(row_multiset(res), want)


def int64_pk_fk():
    return pk_fk(512, 2048, 14, dtype=np.int64)


@pytest.mark.parametrize("case", ["steal", "dense", "pointer", "int64",
                                  "two selected columns"])
def test_other_lattice_points_keep_the_torch_route(monkeypatch, case):
    """ProbeSteal (its partition costs need every row's match range), the
    dense route (duplicate build keys), StorePointer, int64 columns and
    more than one selected column take the torch route with the gate open,
    equal to JAX's."""
    kw = dict(partition_build=True, partition_probe=True, nthreads=4)
    part_b = part_p = (1, 512, 16)
    sel = ([2], [2])
    build, probe = pk_fk(512, 2048, 15)
    if case == "steal":
        kw, part_b, part_p = dict(steal=True, nthreads=4), None, (1, 512, 8)
    elif case == "dense":
        build, probe = dup_tables()
    elif case == "pointer":
        kw["storage"] = "pointer"
    elif case == "int64":
        build, probe = int64_pk_fk()
    else:
        sel = ([2, 1], [2])
    calls = open_probe_gate(monkeypatch)
    kept = PJ.PROBE_KERNEL_BLOCKS
    _, pj, _ = run_both(build, probe, kw, part_b=part_b, part_p=part_p,
                        sel=sel)
    assert calls == [] and PJ.PROBE_KERNEL_BLOCKS == kept
    assert pj.stats.probe_schedule["route"] == \
        ("dense" if case == "dense" else "perm")


def test_run_multijoin_counts_the_probe_kernel_blocks(monkeypatch, tmp_path):
    """Through ``join_tables``: with the gate open every worker block of
    the shared tables' partitioned probe takes the route
    (``probeKernelBlocks`` 4, a port-only field), the line otherwise
    JAX's; with it shut (the CPU's route) the field reads 0."""
    write_npz(tmp_path, np.int32, False)
    j_res = J.run_multijoin(npz_conf("independent"),
                            base_path=str(tmp_path))
    shut = P.run_multijoin(npz_conf("independent"), base_path=str(tmp_path),
                           device=CPU)
    calls = open_probe_gate(monkeypatch)
    p_res = P.run_multijoin(npz_conf("independent"), base_path=str(tmp_path),
                            device=CPU)
    assert shut.fields["probeKernelBlocks"] == 0
    assert p_res.fields["probeKernelBlocks"] == len(calls) == 4
    assert "probeKernelBlocks" in PORT_ONLY_FIELDS
    for res in (shut, p_res):
        assert_same_line(res, j_res)
        np.testing.assert_array_equal(row_multiset(res.output),
                                      row_multiset(j_res.output))
    same(p_res.stats.partition_probe_costs, j_res.stats.partition_probe_costs)


def test_string_payload_join_matches_jax():
    rng = np.random.default_rng(12)
    bkeys = rng.permutation(np.arange(1, 257)).astype(np.int32)
    pkeys = rng.integers(1, 300, 1000).astype(np.int32)
    build = both_tables([bkeys, np.array([f"b{k}" for k in bkeys], object)],
                        types=("long", "string"))
    probe = both_tables([pkeys, np.array([f"p{i}" for i in range(1000)],
                                         object)], types=("long", "string"))
    out, _, _ = run_both(build, probe, dict(partition_build=False),
                         hash_args=(1, 256, 64))
    assert out.num_rows == int((pkeys <= 256).sum())


def test_nested_loops_match_jax():
    build, probe = dup_tables(seed=9, n_r=128, n_s=512, hi=100)
    results = []
    for pkg, (tb, tp) in ((P, (build[1], probe[1])),
                          (J, (build[0], probe[0]))):
        nl = pkg.NestedLoops()
        nl.init(tb.schema, [2], 1, tp.schema, [2], 1)
        nl.build(pkg.NoPartitioner().split(tb))
        results.append((nl.probe(pkg.NoPartitioner().split(tp)), nl))
    (p_out, p_nl), (j_out, j_nl) = results
    assert_same_join(p_out, j_out, p_nl, j_nl)
    assert p_nl.brute_count() == j_nl.brute_count() == p_out.num_rows
    with pytest.raises(RuntimeError):
        P.NestedLoops().brute_count()


@pytest.mark.parametrize("kind", ["perm", "directory", "composite"])
def test_flatmem_matches_jax(kind, monkeypatch):
    if kind == "perm":
        build, probe = pk_fk(1024, 4096, 8)
    else:
        build, probe = dup_tables(seed=10, n_r=1024, n_s=4096, hi=1024)
    if kind == "composite":
        monkeypatch.setattr(JJ, "_DENSE_LIMIT", 0)
        monkeypatch.setattr(PJ, "_DENSE_LIMIT", 0)
    results = []
    for pkg, (tb, tp) in ((P, (build[1], probe[1])),
                          (J, (build[0], probe[0]))):
        h = pkg.ModuloHash(1, 1024, 64)
        rp = pkg.RadixPartitioner(h, passes=2)
        fj = pkg.FlatMemoryJoiner(h, rp)
        fj.init(tb.schema, [2], 1, tp.schema, [2], 1)
        fj.build(rp.split(tb))
        results.append((fj.probe(pkg.NoPartitioner().split(tp)), fj))
    (p_out, pf), (j_out, jf) = results
    assert_same_join(p_out, j_out, pf, jf)
    assert (pf._flat_perm is None) == (jf._flat_perm is None) == \
        (kind != "perm")
    assert (pf._flat_dir is None) == (kind == "composite")


def test_joiner_factory_dispatch_matches_jax():
    h = {"fn": "modulo", "range": [1, 64], "buckets": 8}
    algos = [{"copydata": "yes", "partitionprobe": "yes", "steal": "yes"},
             {"copydata": "no", "partitionbuild": "yes"},
             {"nestedloops": "yes"}, {"flatmem": "yes"}]
    for algo in algos:
        conf = {"algorithm": algo, "threads": 4}
        pj = P.joiner_factory(conf, P.hash_factory(h),
                              build_partitioner=P.RadixPartitioner(
                                  P.hash_factory(h)))
        jj = J.joiner_factory(conf, J.hash_factory(h),
                              build_partitioner=J.RadixPartitioner(
                                  J.hash_factory(h)))
        assert type(pj).__name__ == type(jj).__name__
        for f in ("storage", "partition_build", "partition_probe", "steal",
                  "nthreads"):
            assert getattr(pj, f, None) == getattr(jj, f, None)
    with pytest.raises(ValueError):
        P.joiner_factory({"algorithm": {"flatmem": "yes"}}, P.hash_factory(h),
                         build_partitioner=P.NoPartitioner())
    with pytest.raises(ValueError):
        P.HashJoiner(P.hash_factory(h), partition_build=True, steal=True)


# ---------------------------------------------------------------------------
# the driver on shared .npz tables
# ---------------------------------------------------------------------------

NPZ_CONF = textwrap.dedent("""
    path: ".";
    partitioner: {
        build: { algorithm: "radix"; pagesize: 1024; attribute: 1; passes: 1; };
        probe: { algorithm: "radix"; pagesize: 1024; attribute: 1; passes: 1; };
        hash:  { fn: "modulo"; range: [1, 4096]; buckets: 16; skipbits: 4; };
    };
    build: { file: "r.npz"; schema: ("long", "long"); jattr: 1; select: (2);
             generate: false; };
    probe: { file: "s.npz"; schema: ("long", "long"); jattr: 1; select: (2);
             generate: false; };
    output: "out.tbl";
    hash: { fn: "modulo"; range: [1, 4096]; buckets: 2048; };
    algorithm: { copydata: "yes"; partitionbuild: "yes"; buildpagesize: 32;
                 partitionprobe: "yes"; };
    threads: 4;
""")

CONF_VARIANTS = {
    "radix": ({}, {}),
    "independent": ({"build": "independent", "probe": "independent"}, {}),
    "no_partition": ({"build": "no", "probe": "no"},
                     {"partitionbuild": "no", "partitionprobe": "no"}),
    "steal": ({"build": "no"}, {"partitionbuild": "no", "steal": "yes"}),
    "flatmem": ({"probe": "no"}, {"flatmem": "yes", "partitionprobe": "no"}),
    "pointer": ({}, {"copydata": "no"}),
}


def npz_conf(variant):
    conf = P.parse_conf_string(NPZ_CONF)
    parts, algo = CONF_VARIANTS[variant]
    for side, name in parts.items():
        conf["partitioner"][side]["algorithm"] = name
    conf["algorithm"].update(algo)
    return conf


def write_npz(tmp_path, dtype, dup_build):
    rng = np.random.default_rng(31)
    if dup_build:
        bkeys = rng.integers(1, 4097, 4096)
    else:
        bkeys = rng.permutation(np.arange(1, 4097))
    pkeys = rng.integers(1, 4097, 16384)
    np.savez(tmp_path / "r.npz", bkeys.astype(dtype),
             np.arange(1, 4097).astype(dtype))
    np.savez(tmp_path / "s.npz", pkeys.astype(dtype),
             np.arange(1, 16385).astype(dtype))


def row_multiset(table):
    cols = [arr(table.column(i)).astype(np.int64)
            for i in range(1, len(table.columns) + 1)]
    return np.sort((cols[0] << 32) | cols[1])


def assert_same_line(p_res, j_res):
    p_line, j_line = json.loads(p_res.to_json_line()), \
        json.loads(j_res.to_json_line())
    assert set(p_line) == set(j_line) | PORT_ONLY_FIELDS
    for key, val in j_line.items():
        if key.endswith("TimeNs"):
            assert p_line[key] >= 0
        elif key == "probeSchedule":
            for f in ("policy", "route", "units"):
                assert p_line[key][f] == val[f]
            assert len(p_line[key]["workerMicros"]) == \
                len(val["workerMicros"])
        else:
            assert p_line[key] == val, key


@pytest.mark.parametrize("variant", list(CONF_VARIANTS))
@pytest.mark.parametrize("dtype,dup_build", [(np.int32, False),
                                             (np.int64, True)])
def test_run_multijoin_on_shared_npz_matches_jax(tmp_path, variant, dtype,
                                                 dup_build):
    write_npz(tmp_path, dtype, dup_build)
    conf = npz_conf(variant)
    p_res = P.run_multijoin(conf, base_path=str(tmp_path), device=CPU)
    j_res = J.run_multijoin(npz_conf(variant), base_path=str(tmp_path))
    assert_same_line(p_res, j_res)
    np.testing.assert_array_equal(row_multiset(p_res.output),
                                  row_multiset(j_res.output))
    assert set(p_res.timings_ns) == set(j_res.timings_ns)


def test_cli_prints_the_jax_line_keys(tmp_path, capsys):
    from htm_hashjoin_tpu.wisconsin.__main__ import main as jmain
    from htm_hashjoin_tpu_torch.wisconsin.__main__ import main as pmain
    write_npz(tmp_path, np.int32, False)
    conf_path = tmp_path / "t.conf"
    conf_path.write_text(NPZ_CONF.replace('path: "."',
                                          f'path: "{tmp_path}"'))
    assert pmain([str(conf_path), "--write-output"], device="cpu") == 0
    p_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    p_rows = sorted((tmp_path / "out.tbl").read_text().splitlines())
    assert jmain([str(conf_path), "--write-output"]) == 0
    j_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(p_line) == set(j_line) | PORT_ONLY_FIELDS
    assert p_line["outputRows"] == j_line["outputRows"] == 16384
    assert p_rows == sorted((tmp_path / "out.tbl").read_text().splitlines())
    assert pmain([]) == 2


def test_run_multijoin_needs_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.run_multijoin(npz_conf("radix"))
