"""The port's persistence (``data/persist.py``) and native generator binding
(``data/native.py``) against the JAX package's: the same cache names for
every grid's configs, files written by either package read equal by the
other, the read-through cache, and the native library's arrays."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htm_hashjoin_tpu.data import native as jnative
from htm_hashjoin_tpu.data import persist as jpersist
from htm_hashjoin_tpu.harness import GRIDS as JGRIDS
from htm_hashjoin_tpu.relation import Relation as JRelation
from htm_hashjoin_tpu_torch.config import Algo, Distribution, JoinConfig
from htm_hashjoin_tpu_torch.data import native, persist
from htm_hashjoin_tpu_torch.harness import GRIDS
from htm_hashjoin_tpu_torch.relation import Relation


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_cache_key_equals_jax_for_every_grid_config(name):
    for scale in (4, 8):
        for cfg, jcfg in zip(GRIDS[name](scale), JGRIDS[name](scale)):
            for side in ("r", "s"):
                assert persist.cache_key(cfg, side) == \
                    jpersist.cache_key(jcfg, side)


def test_cache_key_equals_jax_with_every_field_set():
    from htm_hashjoin_tpu.config import Algo as JAlgo
    from htm_hashjoin_tpu.config import Distribution as JDistribution
    from htm_hashjoin_tpu.config import JoinConfig as JJoinConfig
    fields = dict(r_size=1000, s_size=3000, distinct_keys=77,
                  shuffle_range=64, seed=5, zipf_param=1.25)
    for dist in Distribution:
        cfg = JoinConfig(algo=Algo.NPO, data_distr=dist, **fields)
        jcfg = JJoinConfig(algo=JAlgo.NPO,
                           data_distr=JDistribution(dist.value), **fields)
        for side in ("r", "s"):
            assert persist.cache_key(cfg, side) == \
                jpersist.cache_key(jcfg, side)
    assert persist.cache_key(cfg, "r") != persist.cache_key(
        dataclasses.replace(cfg, seed=6), "r")


def arrays(kind):
    rng = np.random.default_rng(4)
    keys = rng.integers(-2**31, 2**31 - 1, 1000).astype(np.int32)
    pay = (rng.integers(-2**31, 2**31 - 1, 1000).astype(np.int32)
           if kind != "npz, keys only" else None)
    return keys, pay


KINDS = ["npz, keys only", "npz with payloads", "tbl"]


@pytest.mark.parametrize("kind", KINDS)
def test_jax_written_files_load_equal_in_the_port(kind, tmp_path):
    keys, pay = arrays(kind)
    path = str(tmp_path / ("rel.tbl" if kind == "tbl" else "rel.npz"))
    jpersist.save_relation(JRelation(jnp.asarray(keys),
                                     None if pay is None
                                     else jnp.asarray(pay)), path)
    got = persist.load_relation(path, device="cpu")
    want = jpersist.load_relation(path)
    assert got.keys.dtype == torch.int32
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(want.keys))
    if want.payloads is None:
        assert got.payloads is None
    else:
        np.testing.assert_array_equal(got.payloads.numpy(),
                                      np.asarray(want.payloads))


@pytest.mark.parametrize("kind", KINDS)
def test_port_written_files_load_equal_in_jax(kind, tmp_path):
    keys, pay = arrays(kind)
    name = "rel.tbl" if kind == "tbl" else "rel.npz"
    ours, theirs = str(tmp_path / ("p" + name)), str(tmp_path / ("j" + name))
    persist.save_relation(Relation(torch.from_numpy(keys),
                                   None if pay is None
                                   else torch.from_numpy(pay)), ours)
    jpersist.save_relation(JRelation(jnp.asarray(keys),
                                     None if pay is None
                                     else jnp.asarray(pay)), theirs)
    if kind == "tbl":
        assert open(ours).read() == open(theirs).read()
    back = jpersist.load_relation(ours)
    np.testing.assert_array_equal(np.asarray(back.keys), keys)
    if kind == "npz, keys only":
        assert back.payloads is None
    else:
        want = pay if pay is not None else np.arange(1, keys.size + 1)
        np.testing.assert_array_equal(np.asarray(back.payloads), want)


def test_npz_suffix_is_added_on_save_and_load(tmp_path):
    rel = Relation(torch.arange(1, 11, dtype=torch.int32))
    persist.save_relation(rel, str(tmp_path / "bare"))
    assert (tmp_path / "bare.npz").exists()
    assert torch.equal(persist.load_relation(str(tmp_path / "bare"),
                                             device="cpu").keys, rel.keys)


def test_cached_relation_reads_through_and_shares_jax_files(tmp_path):
    cfg = JoinConfig(r_size=256, data_distr=Distribution.SHUFFLE, seed=3)
    calls = []

    def gen():
        calls.append(1)
        return Relation(torch.randperm(256, generator=torch.Generator()
                                       .manual_seed(3)).to(torch.int32) + 1)

    first = persist.cached_relation(cfg, "r", str(tmp_path), gen,
                                    device="cpu")
    second = persist.cached_relation(cfg, "r", str(tmp_path), gen,
                                     device="cpu")
    assert len(calls) == 1 and torch.equal(first.keys, second.keys)
    # the JAX package's read-through finds the port's file, and the other
    # way round
    from htm_hashjoin_tpu.config import JoinConfig as JJoinConfig
    from htm_hashjoin_tpu.config import Distribution as JDistribution
    jcfg = JJoinConfig(r_size=256, data_distr=JDistribution.SHUFFLE, seed=3)
    jrel = jpersist.cached_relation(jcfg, "r", str(tmp_path),
                                    lambda: pytest.fail("JAX regenerated"))
    np.testing.assert_array_equal(np.asarray(jrel.keys), first.keys.numpy())
    jpersist.cached_relation(jcfg, "s", str(tmp_path),
                             lambda: JRelation(jnp.arange(1, 9,
                                                          dtype=jnp.int32)))
    srel = persist.cached_relation(cfg, "s", str(tmp_path),
                                   lambda: pytest.fail("port regenerated"),
                                   device="cpu")
    assert srel.keys.tolist() == list(range(1, 9))


def test_cached_relation_gives_a_miss_and_a_hit_one_device(tmp_path):
    """A generator's relation on another device moves to the one asked for,
    as the file read on a hit does; the generator's other fields stay."""
    cfg = JoinConfig(r_size=64, data_distr=Distribution.SORTED)
    rel = Relation(torch.arange(1, 65, dtype=torch.int32), assume_sorted=True)
    miss = persist.cached_relation(cfg, "r", str(tmp_path),
                                   lambda: rel, device="meta")
    hit = persist.cached_relation(cfg, "r", str(tmp_path),
                                  lambda: pytest.fail("regenerated"),
                                  device="meta")
    assert miss.keys.device == hit.keys.device == torch.device("meta")
    assert miss.payloads is None and miss.assume_sorted


def test_persistence_needs_cuda_without_a_device(monkeypatch, tmp_path):
    """Without a device the relation goes to the card, on a hit as on a
    miss; with no card both raise before generating anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = JoinConfig(r_size=16)
    gen = lambda: pytest.fail("generated without a device")  # noqa: E731
    with pytest.raises(RuntimeError, match="CUDA"):
        persist.cached_relation(cfg, "r", str(tmp_path), gen)
    persist.cached_relation(cfg, "r", str(tmp_path),
                            lambda: Relation(torch.arange(1, 17)),
                            device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        persist.cached_relation(cfg, "r", str(tmp_path), gen)
    path = str(tmp_path / (persist.cache_key(cfg, "r") + ".npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        persist.load_relation(path)


NATIVE_CALLS = [
    ("sorted_keys", (1000,)),
    ("shuffled_keys", (1000, 7)),
    ("local_shuffled_keys", (1000, 64, 3)),
    ("uniform_keys", (1000, 100, 16, 2)),
    ("fk_from_pk_keys", (4096, 1024, 5)),
    ("zipf_keys", (1000, 1 << 10, 1.1, 1)),
    ("nonunique_keys", (1000, 50, 9)),
]


@pytest.mark.parametrize("fn,args", NATIVE_CALLS, ids=[c[0] for c in
                                                         NATIVE_CALLS])
def test_native_returns_the_jax_wrappers_arrays(fn, args):
    if not jnative.available():
        pytest.skip("libhtmdatagen.so not built")
    assert native.available()
    got, want = getattr(native, fn)(*args), getattr(jnative, fn)(*args)
    assert got.dtype == np.int32 and isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    assert native.checksum(got) == jnative.checksum(want)
