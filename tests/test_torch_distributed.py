"""The port's distributed join (``parallel/``) against the JAX package's.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port side on the CPU, with 8 shards placed by a device-mapping file
(``8 0 1 2 3 4 5 6 7``: every id wraps onto the one CPU device) or with an
explicit ``Mesh``.  Inputs are the JAX package's own relations, handed to
both packages as numpy arrays.  Tolerance: exact, every output is an
integer.

- One counterpart per test of ``tests/test_distributed.py`` (same sizes
  and parameters): the JAX test's claims on the port, and the port's line
  equal to JAX's ``distributed_join`` line field for field but the times.
- The parts against JAX's on the same shard inputs: ``_bucketize_by``
  (the residual as a multiset: JAX compacts it with an unstable sort),
  ``_detect_hot_keys`` and ``_union_hot``, ``_residual_matches``.
- The hierarchical exchange receives the flat one's arrays bit for bit.
- The mesh, the mapping file and the collectives; reference fault 9 (R key
  0, S key INT32_MAX), which the port does not copy; the dry run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from htm_hashjoin_tpu import config as jconfig
from htm_hashjoin_tpu.data.generators import build_relations as jbuild
from htm_hashjoin_tpu.data.generators import zipf_keys as jzipf_keys
from htm_hashjoin_tpu.parallel import dist_join as jdist
from htm_hashjoin_tpu.parallel.mesh import make_mesh as jmake_mesh
from htm_hashjoin_tpu.relation import Relation as JRelation
from htm_hashjoin_tpu.utils.validate import reference_match_count
from htm_hashjoin_tpu_torch.config import Algo, Distribution, JoinConfig
from htm_hashjoin_tpu_torch.joins import DISPATCH
from htm_hashjoin_tpu_torch.parallel import collectives as cc
from htm_hashjoin_tpu_torch.parallel import dist_join
from htm_hashjoin_tpu_torch.parallel.dist_join import distributed_join
from htm_hashjoin_tpu_torch.parallel.dryrun import dryrun_multichip
from htm_hashjoin_tpu_torch.parallel.mesh import (MAPPING_ENV, Mesh,
                                                  load_device_mapping,
                                                  make_mesh, shard_relation)
from htm_hashjoin_tpu_torch.relation import Relation, keys_from_numpy

N = 1 << 14
CPU = torch.device("cpu")
INT32_MAX = 2**31 - 1


@pytest.fixture
def mapping8(tmp_path, monkeypatch):
    """A device-mapping file that places 8 shards on the one CPU device
    (and the JAX package's 8 virtual devices in their own order)."""
    path = tmp_path / "device-mapping.txt"
    path.write_text("8 0 1 2 3 4 5 6 7\n")
    monkeypatch.setenv(MAPPING_ENV, str(path))
    return path


def cfgs(**kw):
    base = dict(algo=jconfig.Algo.RADIX, r_size=N, mesh_shape=(8,))
    base.update(kw)
    return jconfig.JoinConfig(**base)


def port_cfg(jcfg) -> JoinConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jconfig.JoinConfig)}
    fields["algo"] = Algo(jcfg.algo.value)
    fields["data_distr"] = Distribution(jcfg.data_distr.value)
    if jcfg.s_distr is not None:
        fields["s_distr"] = Distribution(jcfg.s_distr.value)
    return JoinConfig(**fields)


def port_relations(jr, js):
    return (Relation(keys_from_numpy(np.asarray(jr.keys))),
            Relation(keys_from_numpy(np.asarray(js.keys)),
                     assume_sorted=js.assume_sorted))


def untimed(m) -> dict:
    return {k: v for k, v in m.to_dict().items() if "Time" not in k}


def both(jcfg, jr=None, js=None, jmesh=None, mesh=None):
    """(port metrics, JAX metrics, JAX R, JAX S) of one configuration on
    the JAX package's relations, the port's line held equal to JAX's."""
    if jr is None:
        jr, js = jbuild(jcfg)
    want = jdist.distributed_join(jr, js, jcfg, mesh=jmesh)
    got = distributed_join(*port_relations(jr, js), port_cfg(jcfg),
                           mesh=mesh)
    assert untimed(got) == untimed(want)
    assert got.hashBuildTimeInMicroseconds > 0
    return got, want, jr, js


# ---------------------------------------------------------------------------
# counterparts of tests/test_distributed.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", [Distribution.SORTED, Distribution.SHUFFLE,
                                  Distribution.LOCAL_SHUFFLE])
def test_dist_matches_pk(mapping8, dist):
    m, _, _, _ = both(cfgs(data_distr=jconfig.Distribution(dist.value)))
    assert m.totalMatches == N
    assert m.conserved
    assert m.extra["droppedR"] == 0 and m.extra["droppedS"] == 0
    assert m.extra["nDevices"] == 8 and m.extra["meshShape"] == [8]


def test_dist_equals_single_device(mapping8):
    jcfg = cfgs(data_distr=jconfig.Distribution.UNIFORM, distinct_keys=N // 2)
    multi, _, jr, js = both(jcfg)
    r, s = port_relations(jr, js)
    single = DISPATCH["radix"](r, s, port_cfg(jcfg))
    assert multi.totalMatches == single.totalMatches


def test_skew_handling_exact_on_zipf(mapping8):
    base = dict(data_distr=jconfig.Distribution.ZIPF, distinct_keys=N // 16,
                zipf_param=1.2)
    cfg_on = cfgs(**base, skew_handling=True)
    jr, js = jbuild(cfg_on)
    oracle = reference_match_count(jr.keys, js.keys)
    m_off, _, _, _ = both(cfgs(**base, skew_handling=False,
                               residual_repair=False), jr, js)
    assert m_off.extra["droppedR"] > 0          # the motivating failure
    assert m_off.totalMatches < oracle
    m_on, _, _, _ = both(cfg_on, jr, js)
    assert m_on.totalMatches == oracle
    assert m_on.extra["droppedR"] == 0
    assert m_on.extra["hotKeys"] > 0
    assert m_on.conserved


@pytest.mark.parametrize("shape", [(8,), (2, 4)])
def test_residual_repair_exact_on_forced_overflow(mapping8, shape):
    m, _, jr, js = both(cfgs(data_distr=jconfig.Distribution.ZIPF,
                             distinct_keys=N // 16, zipf_param=1.2,
                             mesh_shape=shape, shuffle_capacity_factor=1.0,
                             skew_handling=False))
    assert m.extra["repairedR"] + m.extra["repairedS"] > 0
    assert m.extra["droppedR"] == 0 and m.extra["droppedS"] == 0
    assert m.totalMatches == reference_match_count(jr.keys, js.keys)
    assert m.conserved


def test_residual_repair_idle_on_benign(mapping8):
    m, _, _, _ = both(cfgs(data_distr=jconfig.Distribution.SHUFFLE))
    assert m.extra["repairedR"] == 0 and m.extra["repairedS"] == 0
    assert m.totalMatches == N and m.conserved


def test_uneven_size_padding(mapping8):
    m, _, _, _ = both(jconfig.JoinConfig(
        algo=jconfig.Algo.RADIX, r_size=N + 13, s_size=N + 7,
        data_distr=jconfig.Distribution.SHUFFLE, mesh_shape=(8,)))
    assert m.totalMatches == N + 7


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_hierarchical_matches_flat(mapping8, shape):
    for dist, kw in [(jconfig.Distribution.SHUFFLE, {}),
                     (jconfig.Distribution.UNIFORM,
                      dict(distinct_keys=N // 2))]:
        cfg2 = cfgs(data_distr=dist, mesh_shape=shape, **kw)
        jr, js = jbuild(cfg2)
        flat, _, _, _ = both(cfgs(data_distr=dist, **kw), jr, js)
        hier, _, _, _ = both(cfg2, jr, js)
        assert hier.totalMatches == flat.totalMatches
        assert hier.extra["hierarchical"] and not flat.extra["hierarchical"]
        assert hier.extra["droppedR"] == 0 and hier.extra["droppedS"] == 0
        assert hier.conserved


def test_hierarchical_skew_handling(mapping8):
    m, _, jr, js = both(cfgs(data_distr=jconfig.Distribution.ZIPF,
                             distinct_keys=N // 16, zipf_param=1.2,
                             mesh_shape=(2, 4), skew_handling=True))
    assert m.totalMatches == reference_match_count(jr.keys, js.keys)
    assert m.extra["droppedR"] == 0 and m.extra["hotKeys"] > 0


def test_mesh_construction(mapping8):
    mesh = make_mesh((8,), device=CPU)
    assert mesh.size == 8 and mesh.devices.size == 8
    assert mesh.shard_devices == [CPU] * 8      # the wrap rule
    with pytest.raises(ValueError, match="needs 1024 devices"):
        make_mesh((1024,), device=CPU)


def test_device_mapping_file_controls_order(tmp_path, monkeypatch):
    """On a host with 8 cards (faked: no tensor is made), a reversed
    mapping places shard d on cuda:7-d, as JAX's places it on device
    7-d."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    ids = list(range(8))[::-1]
    p = tmp_path / "device-mapping.txt"
    p.write_text("8 " + " ".join(map(str, ids)) + "\n")
    monkeypatch.setenv(MAPPING_ENV, str(p))
    assert load_device_mapping() == ids
    mesh = make_mesh((8,), device="cuda")
    assert [d.index for d in mesh.devices.flat] == ids
    jmesh = jmake_mesh((8,))
    assert [d.id for d in jmesh.devices.flat] == ids


def test_device_mapping_malformed_rejected(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("5 0 1\n")  # claims 5 ids, provides 2
    with pytest.raises(ValueError, match="malformed"):
        load_device_mapping(str(p))
    p.write_text("")
    with pytest.raises(ValueError, match="malformed"):
        load_device_mapping(str(p))


def test_no_mapping_default_order(monkeypatch, tmp_path):
    monkeypatch.delenv(MAPPING_ENV, raising=False)
    monkeypatch.chdir(tmp_path)              # no ./device-mapping.txt
    assert make_mesh(device=CPU).shard_devices == [CPU]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert make_mesh(device="cuda").shard_devices == [
        torch.device("cuda", i) for i in range(3)]
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        make_mesh((8,), device=CPU)         # one card (or CPU), no mapping


def test_hierarchical_custom_axis_names():
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    jmesh = jax.sharding.Mesh(devs, ("outer", "inner"))
    mesh = Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 4),
                ("outer", "inner"))
    jcfg = jconfig.JoinConfig(algo=jconfig.Algo.HTM, r_size=1 << 12,
                              data_distr=jconfig.Distribution.SHUFFLE)
    m, _, _, _ = both(jcfg, jmesh=jmesh, mesh=mesh)
    assert m.totalMatches == 1 << 12
    assert m.inputSum == m.outputSum
    assert m.algo == "dist_htm" and m.extra["hierarchical"]


def test_hierarchical_repair_covers_stage2_bound(mapping8):
    m, _, jr, js = both(cfgs(data_distr=jconfig.Distribution.ZIPF,
                             distinct_keys=4, zipf_param=1.3,
                             mesh_shape=(2, 4), shuffle_capacity_factor=1.0,
                             skew_handling=False))
    assert m.extra["repairedR"] + m.extra["repairedS"] > 0
    assert m.extra["droppedR"] == 0 and m.extra["droppedS"] == 0
    assert m.totalMatches == reference_match_count(jr.keys, js.keys)
    assert m.conserved


# ---------------------------------------------------------------------------
# the parts, on the same shard inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap,pad,res_cap,inactive", [
    (40, INT32_MAX, 1024, 0), (40, 0, 1024, 100), (200, INT32_MAX, 1024, 7),
    (12, 0, 0, 30), (40, INT32_MAX, 100, 0)])
def test_bucketize_by_matches_jax(cap, pad, res_cap, inactive):
    rng = np.random.default_rng(cap + res_cap + inactive)
    n, nb = 1024, 8
    keys = rng.integers(1, 5000, n).astype(np.int32)
    dest = rng.integers(0, nb, n).astype(np.int32)
    dest[: n // 3] = 3                        # one hot destination
    active = np.ones(n, bool)
    active[rng.choice(n, inactive, replace=False)] = False
    jb, jres, jovf, jsum = jdist._bucketize_by(
        jnp.asarray(keys), jnp.asarray(dest), jnp.asarray(active), nb, cap,
        jnp.int32(pad), res_cap=res_cap)
    b, fill, res, n_res, ovf, act_sum = dist_join._bucketize_by(
        torch.from_numpy(keys), torch.from_numpy(dest),
        torch.from_numpy(active), nb, cap, pad, res_cap=res_cap)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(fill.numpy(),
                                  (np.asarray(jb) != pad).sum(axis=1))
    assert int(ovf) == int(jovf) > 0 and int(act_sum) == int(jsum)
    jres = np.asarray(jres)
    assert res.numel() == jres.size == res_cap
    assert int(n_res) == (min(int(ovf), res_cap) if res_cap else 0)
    if int(ovf) <= res_cap:
        np.testing.assert_array_equal(np.sort(res[:int(n_res)].numpy()),
                                      np.sort(jres[jres != pad]))
    else:
        # a full buffer: each package keeps res_cap of the misfits, JAX in
        # its unstable sort's order, the port the first in bucket order
        assert (jres != pad).sum() == res_cap
        misfits = set(keys[active].tolist())
        assert set(res.tolist()) <= misfits


def jax_detect(keys, active, ndev):
    fn = shard_map(
        lambda k, a: jdist._detect_hot_keys(k, a, "x", ndev)[None],
        mesh=jmake_mesh((ndev,)), in_specs=(P("x"), P("x")),
        out_specs=P("x"))
    hot = np.asarray(jax.jit(fn)(jnp.asarray(keys), jnp.asarray(active)))
    assert (hot == hot[0]).all()              # the same on every device
    return hot[0]


def port_detect(keys, active, ndev):
    mesh = Mesh(np.array([CPU] * ndev, dtype=object), ("x",))
    hot = dist_join._detect_hot_keys(
        shard_relation(torch.from_numpy(keys), mesh),
        shard_relation(torch.from_numpy(active), mesh), mesh, "x", ndev)
    assert all(h is hot[0] for h in hot)      # one hot set a device
    return hot[0]


def as_jax_hot(hot: torch.Tensor) -> np.ndarray:
    """The port's int64 hot set with the JAX package's padding."""
    return torch.where(hot == dist_join.HOT_PAD, INT32_MAX, hot).numpy()


@pytest.mark.parametrize("per_dev,theta,inactive", [
    (2048, 1.2, 0), (4096, 1.0, 500), (16, 1.2, 0), (64, 1.2, 3)])
def test_detect_hot_keys_matches_jax_and_the_threshold(per_dev, theta,
                                                       inactive):
    """Zipf shards, long ones and ones shorter than SAMPLE_PER_DEV
    (threshold 4): the hot set equals JAX's, and equals every sampled key
    that clears the threshold — topk's order among equal counts cannot
    change it, since at most 2·ndev keys clear the threshold."""
    ndev = 8
    keys = np.array(jzipf_keys(ndev * per_dev, 512, theta, 3))
    active = np.ones(keys.size, bool)
    active[keys.size - inactive:] = False
    got = port_detect(keys, active, ndev)
    np.testing.assert_array_equal(as_jax_hot(got),
                                  jax_detect(keys, active, ndev))
    take = min(per_dev, dist_join.SAMPLE_PER_DEV)
    sample = np.concatenate([
        keys[d * per_dev:d * per_dev + take][active[d * per_dev:
                                                     d * per_dev + take]]
        for d in range(ndev)])
    vals, counts = np.unique(sample, return_counts=True)
    thresh = max(4, ndev * take // (2 * ndev))
    want = np.sort(vals[counts >= thresh])
    assert 0 < want.size <= 2 * ndev
    np.testing.assert_array_equal(got[got < dist_join.HOT_PAD].numpy(), want)


def test_union_hot_matches_jax():
    rng = np.random.default_rng(5)
    a = np.full(dist_join.HOT_CAP, INT32_MAX, np.int64)
    b = a.copy()
    a[:40] = np.sort(rng.choice(1000, 40, replace=False) + 1)
    b[:70] = np.sort(rng.choice(1000, 70, replace=False) + 1)
    want = np.asarray(jdist._union_hot(jnp.asarray(a, jnp.int32),
                                       jnp.asarray(b, jnp.int32)))
    a[a == INT32_MAX] = dist_join.HOT_PAD
    b[b == INT32_MAX] = dist_join.HOT_PAD
    got = dist_join._union_hot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.numel() == want.size == 2 * dist_join.HOT_CAP
    np.testing.assert_array_equal(as_jax_hot(got), want)


def test_residual_matches_matches_jax():
    """Per-shard local contributions of the repair round, on residual
    buffers JAX pads with its sentinels and the port trims to their
    counts, and receive buffers the port masks by their fills."""
    ndev, res_cap, recv = 8, 64, 256
    rng = np.random.default_rng(9)
    n_r = rng.integers(0, res_cap, ndev)
    n_s = rng.integers(0, res_cap, ndev)
    r_res = np.full((ndev, res_cap), INT32_MAX, np.int32)
    s_res = np.zeros((ndev, res_cap), np.int32)
    for d in range(ndev):
        r_res[d, :n_r[d]] = rng.integers(1, 300, n_r[d])
        s_res[d, :n_s[d]] = rng.integers(1, 300, n_s[d])
    r_recv = rng.integers(1, 300, (ndev, recv)).astype(np.int32)
    s_recv = rng.integers(1, 300, (ndev, recv)).astype(np.int32)
    r_ok = rng.random((ndev, recv)) < 0.6
    s_ok = rng.random((ndev, recv)) < 0.6
    r_recv[~r_ok] = INT32_MAX
    s_recv[~s_ok] = 0
    fn = shard_map(
        lambda a, b, c, d: jdist._residual_matches(a, b, c, d, "x")[None],
        mesh=jmake_mesh((ndev,)), in_specs=(P("x"),) * 4, out_specs=P("x"))
    want = np.asarray(jax.jit(fn)(*(jnp.asarray(x.reshape(-1)) for x in
                                    (r_res, s_res, r_recv, s_recv))))
    mesh = Mesh(np.array([CPU] * ndev, dtype=object), ("x",))
    t = torch.from_numpy
    got = dist_join._residual_matches(
        [t(r_res[d, :n_r[d]]) for d in range(ndev)],
        [t(s_res[d, :n_s[d]]) for d in range(ndev)],
        list(t(r_recv)), list(t(s_recv)), list(t(r_ok)), list(t(s_ok)),
        mesh, "x")
    assert [int(x) for x in got] == want.tolist()
    assert sum(want.tolist()) > 0


def test_count_sorted_leaves_out_padding():
    build = torch.tensor([0, 5, 5, INT32_MAX, -3], dtype=torch.int32)
    probe = torch.tensor([INT32_MAX, 5, 0, -3, 7], dtype=torch.int32)
    assert int(dist_join._count_sorted(build, probe)) == 1 + 2 + 1 + 1
    b_ok = torch.tensor([False, True, True, True, True])
    p_ok = torch.tensor([True, True, False, True, True])
    assert int(dist_join._count_sorted(build, probe, b_ok, p_ok)) == 1 + 2 + 1


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_hierarchical_exchange_receives_the_flat_arrays(shape):
    rng = np.random.default_rng(shape[0])
    keys = torch.from_numpy(rng.integers(1, 1 << 20, 8 * 512)
                            .astype(np.int32))
    flat_mesh = Mesh(np.array([CPU] * 8, dtype=object), ("x",))
    hier_mesh = Mesh(np.array([CPU] * 8, dtype=object).reshape(shape),
                     ("host", "chip"))
    shards = shard_relation(keys, flat_mesh)
    active = dist_join._active(shards, keys.numel() - 100)
    flat = dist_join._exchange_flat(shards, active, flat_mesh, "x", 8, 40,
                                    dist_join.R_PAD, res_cap=512)
    hier = dist_join._exchange_hier(shards, active, hier_mesh, 8, *shape, 40,
                                    dist_join.R_PAD, res_cap=512)
    assert int(sum(o.sum() for o in flat.overflow)) > 0
    for a, b in zip(flat, hier):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def test_collectives_follow_lax_semantics():
    H, C = 2, 4
    mesh = Mesh(np.array([CPU] * 8, dtype=object).reshape(H, C),
                ("host", "chip"))
    assert cc.groups(mesh, "chip") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert cc.groups(mesh, "host") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert cc.groups(mesh, ("host", "chip")) == [list(range(8))]
    assert cc.groups(mesh, ("chip", "host")) == [[0, 4, 1, 5, 2, 6, 3, 7]]
    assert cc.axis_index(mesh, "host") == [0, 0, 0, 0, 1, 1, 1, 1]
    assert cc.axis_index(mesh, "chip") == [0, 1, 2, 3] * 2
    # x[d][j] = 10*d + j: member j receives chunk j of every member
    xs = [torch.arange(C) + 10 * d for d in range(8)]
    out = cc.all_to_all(xs, mesh, "chip")
    for d in range(8):
        h, c = divmod(d, C)
        assert out[d].tolist() == [10 * (h * C + i) + c for i in range(C)]
    g = cc.all_gather([torch.tensor([d]) for d in range(8)], mesh, "host",
                      tiled=True)
    assert g[1].tolist() == [1, 5] and g[1] is g[5]   # shared, not copied
    s = cc.psum([torch.tensor(d) for d in range(8)], mesh, "chip")
    assert [int(x) for x in s] == [6] * 4 + [22] * 4
    m = cc.pmax([torch.tensor(d) for d in range(8)], mesh, ("host", "chip"))
    assert [int(x) for x in m] == [7] * 8
    with pytest.raises(ValueError, match="not mesh axes"):
        cc.psum(xs, mesh, "x")
    with pytest.raises(ValueError, match="does not split"):
        cc.all_to_all([torch.arange(3)] * 8, mesh, "chip")


# ---------------------------------------------------------------------------
# reference fault 9, the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["R key 0", "S key INT32_MAX"])
def test_padding_is_not_matched(mapping8, case):
    """The JAX package tells padding from data by sentinel value, so R key
    0 matches every S padding slot and S key INT32_MAX every R padding slot
    (4674 matches where 4095 is exact, pinned here so the fault stays
    documented); the port knows padding by position and counts."""
    n = 1 << 12
    r = np.arange(1, n + 1, dtype=np.int32)
    s = r.copy()
    if case == "R key 0":
        r[100] = 0
    else:
        s[100] = INT32_MAX
    jcfg = jconfig.JoinConfig(algo=jconfig.Algo.RADIX, r_size=n,
                              mesh_shape=(8,))
    want = jdist.distributed_join(JRelation(jnp.asarray(r)),
                                  JRelation(jnp.asarray(s)), jcfg)
    got = distributed_join(Relation(keys_from_numpy(r)),
                           Relation(keys_from_numpy(s)), port_cfg(jcfg))
    assert want.totalMatches == 4674
    assert got.totalMatches == reference_match_count(r, s) == n - 1
    assert got.inputSum == got.outputSum == int(r.sum(dtype=np.int64))


def test_dryrun_multichip_on_the_cpu(mapping8):
    dryrun_multichip(8, device="cpu")
    dryrun_multichip(2, device="cpu")


def test_dryrun_needs_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(8)


def test_dist_line_without_s_counts_nothing(mapping8):
    jr, _ = jbuild(cfgs(data_distr=jconfig.Distribution.SHUFFLE))
    jcfg = cfgs(data_distr=jconfig.Distribution.SHUFFLE)
    want = jdist.distributed_join(jr, None, jcfg)
    got = distributed_join(Relation(keys_from_numpy(np.asarray(jr.keys))),
                           None, port_cfg(jcfg))
    assert untimed(got) == untimed(want)
    assert got.totalMatches == 0 and got.conserved
