"""The port's htm, radix and adaptive joins against the JAX package's on the
same relations: both packages get the same numpy keys (made by the port's
seeded generators), the JAX side on its banded engine (``backend="pallas"``,
Pallas in interpret mode, as ``tests/test_backend_select.py`` runs it),
the port on its default ``auto`` (the kernels' plain versions on the CPU).

Equal on both sides: totalMatches, inputSum, outputSum; chosenPath,
sniffMaxKey, sniffDense, firstRoundFailureFraction; backend; the
adaptivePlan's window and presort (and its sniff statistics); passBits,
passShifts, numPasses, fanout; and the JSON line's key set.  The match
count must also equal an exact numpy count.  Tolerance 0: integer outputs,
and the duplicate fraction is the same float32 division on both sides.

Expected differences (ROADMAP queue 3), not compared: violations and
flagged tiles (the port's tile is 8192 keys, JAX's 65536), ``resorted``,
and the multipass ``maxRunSize`` (tile 2048 against JAX's 1024 below 2^17
keys).
"""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest

from htm_hashjoin_tpu import config as jconfig
from htm_hashjoin_tpu.joins import adaptive as jadaptive
from htm_hashjoin_tpu.joins import htm as jhtm
from htm_hashjoin_tpu.joins import radix as jradix
from htm_hashjoin_tpu.relation import Relation as JRelation
from htm_hashjoin_tpu_torch.config import Algo, Distribution, JoinConfig
from htm_hashjoin_tpu_torch.data.generators import build_relations
from htm_hashjoin_tpu_torch.joins import adaptive, htm, radix
from htm_hashjoin_tpu_torch.relation import Relation, keys_from_numpy
from htm_hashjoin_tpu_torch.utils.validate import reference_match_count

N = 1 << 14

JOINS = {"htm": (htm.htm_join, jhtm.htm_join),
         "radix": (radix.radix_join, jradix.radix_join),
         "adaptive": (adaptive.adaptive_join, jadaptive.adaptive_join)}

EQUAL = ("totalMatches", "inputSum", "outputSum", "chosenPath",
         "sniffMaxKey", "sniffDense", "firstRoundFailureFraction", "backend",
         "passBits", "passShifts", "numPasses", "fanout", "radixBits",
         "switchedToRadix", "maxPartitionSize", "skewedPartitions")
PLAN = ("window", "presort", "maxDisplacement", "sampleDuplicates",
        "windowEstimate", "dialCached", "sampleChunks", "sampleChunkSize")


def jax_cfg(cfg: JoinConfig, **changes):
    """The JAX package's JoinConfig with the same fields, on its banded
    engine."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(JoinConfig)}
    fields["algo"] = jconfig.Algo(cfg.algo.value)
    fields["data_distr"] = jconfig.Distribution(cfg.data_distr.value)
    if cfg.s_distr is not None:
        fields["s_distr"] = jconfig.Distribution(cfg.s_distr.value)
    fields.update(backend="pallas", **changes)
    return jconfig.JoinConfig(**fields)


def relations(cfg: JoinConfig):
    """(port R, port S, JAX R, JAX S, numpy R, numpy S): the same keys."""
    r, s = build_relations(cfg)
    rk, sk = r.to_numpy(), s.to_numpy()
    return (Relation(keys_from_numpy(rk)),
            Relation(keys_from_numpy(sk), assume_sorted=s.assume_sorted),
            JRelation(jnp.asarray(rk)),
            JRelation(jnp.asarray(sk), assume_sorted=s.assume_sorted), rk, sk)


CASES = {
    "htm_local_w16": ("htm", dict(data_distr=Distribution.LOCAL_SHUFFLE)),
    "htm_shuffle": ("htm", dict(data_distr=Distribution.SHUFFLE)),
    "htm_sorted": ("htm", dict(data_distr=Distribution.SORTED)),
    "htm_wide_w600": ("htm", dict(data_distr=Distribution.LOCAL_SHUFFLE,
                                  shuffle_range=600)),
    "htm_uniform_duplicates": ("htm", dict(data_distr=Distribution.UNIFORM,
                                           distinct_keys=N // 4)),
    "htm_build_only_local": ("htm", dict(data_distr=Distribution.LOCAL_SHUFFLE,
                                         enable_probe=False)),
    "htm_switch_zipf": ("htm", dict(data_distr=Distribution.ZIPF,
                                    switch_sniff=True)),
    "htm_switch_local": ("htm", dict(data_distr=Distribution.LOCAL_SHUFFLE,
                                     switch_sniff=True)),
    "htm_track_dial_build_only": ("htm", dict(
        data_distr=Distribution.LOCAL_SHUFFLE, enable_probe=False,
        track=True, adaptive=True)),
    "htm_track_join": ("htm", dict(data_distr=Distribution.LOCAL_SHUFFLE,
                                   track=True)),
    "radix_uniform_duplicates": ("radix", dict(
        data_distr=Distribution.UNIFORM, distinct_keys=N // 4)),
    "radix_pk_zipf_s": ("radix", dict(data_distr=Distribution.PK,
                                      s_distr=Distribution.ZIPF,
                                      zipf_param=1.0)),
    "radix_random_sort_route": ("radix", dict(data_distr=Distribution.RANDOM)),
    "radix_multipass": ("radix", dict(data_distr=Distribution.SHUFFLE,
                                      radix_bits=6, radix_passes=2,
                                      radix_strategy="multipass")),
    "radix_multipass_build_only": ("radix", dict(
        data_distr=Distribution.PK, radix_bits=6, radix_passes=3,
        radix_strategy="multipass", enable_probe=False)),
    "adaptive_local": ("adaptive", dict(data_distr=Distribution.LOCAL_SHUFFLE)),
    "adaptive_zipf": ("adaptive", dict(data_distr=Distribution.ZIPF,
                                       distinct_keys=N // 4)),
    "adaptive_random": ("adaptive", dict(data_distr=Distribution.RANDOM)),
}


@functools.lru_cache(maxsize=None)
def run_case(name):
    algo, fields = CASES[name]
    cfg = JoinConfig(algo=Algo(algo), r_size=N, seed=3, **fields)
    r, s, jr, js, rk, sk = relations(cfg)
    port_join, jax_join = JOINS[algo]
    probing = cfg.enable_probe
    got = port_join(r, s if probing else None, cfg).to_dict()
    want = jax_join(jr, js if probing else None, jax_cfg(cfg)).to_dict()
    return got, want, rk, sk


def assert_lines_agree(got, want):
    assert set(got) == set(want)
    for key in EQUAL:
        assert got.get(key) == want.get(key), key
    if "adaptivePlan" in want:
        for key in PLAN:
            assert got["adaptivePlan"].get(key) == \
                want["adaptivePlan"].get(key), key


@pytest.mark.parametrize("name", list(CASES))
def test_join_matches_jax(name):
    got, want, rk, sk = run_case(name)
    assert_lines_agree(got, want)
    assert got["inputSum"] == got["outputSum"] == int(rk.astype(np.int64).sum())
    if CASES[name][1].get("enable_probe", True):
        assert got["totalMatches"] == reference_match_count(rk, sk)
    else:
        assert "totalMatches" not in got


@pytest.mark.parametrize("name,path,backend", [
    ("htm_local_w16", None, "pallas_banded"),
    ("htm_switch_zipf", None, "pallas_banded"),
    ("radix_random_sort_route", None, None),
    ("radix_multipass", None, "pallas_multipass_radix"),
    ("adaptive_local", "htm", "pallas_banded"),
    ("adaptive_zipf", "radix", "pallas_banded"),
    ("adaptive_random", "radix", None)])
def test_join_takes_the_expected_path(name, path, backend):
    got, _, _, _ = run_case(name)
    assert got.get("chosenPath") == path and got.get("backend") == backend
    if name == "htm_switch_zipf":
        assert got["switchedToRadix"] is True
        assert got["firstRoundFailureFraction"] >= 0.004
    if name == "radix_multipass":
        assert got["passBits"] == [3, 3] and got["passShifts"] == [12, 9]


@pytest.mark.parametrize("distr", [Distribution.LOCAL_SHUFFLE,
                                   Distribution.SHUFFLE])
@pytest.mark.parametrize("probing", [True, False])
def test_dial_and_its_cache_match_jax(distr, probing):
    """HTM_ADAPT: the fused sniff + optimistic guess, then a second join
    over the same relation served from the dial cache; both packages pick
    the same plan from the same sniff statistics."""
    cfg = JoinConfig(algo=Algo.HTM, r_size=N, data_distr=distr, seed=5,
                     adaptive=True, enable_probe=probing)
    r, s, jr, js, rk, sk = relations(cfg)
    jcfg = jax_cfg(cfg)
    for round_ in range(2):
        got = htm.htm_join(r, s if probing else None, cfg).to_dict()
        want = jhtm.htm_join(jr, js if probing else None, jcfg).to_dict()
        assert_lines_agree(got, want)
        assert got["adaptivePlan"].get("dialCached", False) == (round_ == 1)
        assert got["adaptiveTransactionSizeFinal"] == \
            want["adaptiveTransactionSizeFinal"]
        if probing:
            assert got["totalMatches"] == N
    if distr == Distribution.SHUFFLE:      # the guess aborted: dialed plan
        assert got["adaptivePlan"]["window"] is None
        assert got["adaptivePlan"]["presort"] == probing


def test_dial_cache_misses_for_a_new_tensor_with_the_same_keys():
    cfg = JoinConfig(algo=Algo.HTM, r_size=N, seed=6, adaptive=True,
                     data_distr=Distribution.LOCAL_SHUFFLE)
    r, s, _, _, rk, _ = relations(cfg)
    htm.htm_join(r, s, cfg)
    again = Relation(keys_from_numpy(rk))
    line = htm.htm_join(again, s, cfg).to_dict()
    assert "dialCached" not in line["adaptivePlan"]


def test_track_build_divides_by_the_port_tile():
    """TM_TRACK's per-chunk fractions: violations per tile over the port's
    tile (the JAX package divides by its 65536-key tile)."""
    data = JoinConfig(algo=Algo.HTM, r_size=N, seed=7, track=True,
                      enable_probe=False, shuffle_range=64,
                      data_distr=Distribution.LOCAL_SHUFFLE)
    r, _, _, _, _, _ = relations(data)
    line = htm.htm_join(r, None,
                        dataclasses.replace(data, shuffle_range=4)).to_dict()
    assert line["failureCauseDisplacement"] > 0
    fractions = line["chunkFailureFractions"]
    assert len(fractions) == N // radix.DEFAULT_TILE
    assert sum(f * radix.DEFAULT_TILE for f in fractions) == \
        line["failureCauseDisplacement"]
    assert line["inputSum"] == line["outputSum"]


@pytest.mark.parametrize("cfg", [
    dict(backend="xla"),
    dict(data_distr=Distribution.UNIFORM, enable_probe=False),
    dict(data_distr=Distribution.RANDOM)])
def test_xla_build_formulation_raises(cfg):
    """The JAX package's XLA scatter build (ops/insert.py) is not ported:
    the joins that would take it raise, naming the queue item."""
    cfg = JoinConfig(algo=Algo.HTM, r_size=1024, **cfg)
    r, s = build_relations(cfg)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        htm.htm_join(r, s if cfg.enable_probe else None, cfg)


def test_simulate_adaptive_tsize_matches_jax():
    fails = [0.0, 0.001, 0.03, 0.05, 0.01, 0.0, 0.0, 0.5]
    assert htm.simulate_adaptive_tsize(fails, 16) == \
        jhtm.simulate_adaptive_tsize(fails, 16)


@pytest.mark.parametrize("algo,fields", [
    ("htm", dict(data_distr=Distribution.LOCAL_SHUFFLE)),
    ("htm", dict(data_distr=Distribution.SHUFFLE, enable_probe=False)),
    ("radix", dict(data_distr=Distribution.RANDOM, enable_probe=False))])
def test_sustained_timing_lines_match_jax(algo, fields):
    """pipeline_depth > 1: the join is enqueued that many times and fenced
    once; the line keeps the single-run time beside the sustained one."""
    cfg = JoinConfig(algo=Algo(algo), r_size=N, seed=8, pipeline_depth=3,
                     **fields)
    r, s, jr, js, _, _ = relations(cfg)
    probing = cfg.enable_probe
    port_join, jax_join = JOINS[algo]
    got = port_join(r, s if probing else None, cfg).to_dict()
    want = jax_join(jr, js if probing else None, jax_cfg(cfg)).to_dict()
    assert_lines_agree(got, want)
    assert got["pipelineDepth"] == 3 and got["singleRunTimeInMicroseconds"] > 0


@pytest.mark.parametrize("probing", [True, False])
@pytest.mark.parametrize("distr,window", [
    (Distribution.SORTED, 16), (Distribution.SHUFFLE, 16),
    (Distribution.UNIFORM, 16), (Distribution.PK_LSHUFFLE, 8),
    (Distribution.LOCAL_SHUFFLE, 1), (Distribution.LOCAL_SHUFFLE, 512),
    (Distribution.LOCAL_SHUFFLE, 513), (Distribution.LOCAL_SHUFFLE, 61376),
    (Distribution.LOCAL_SHUFFLE, 61377), (Distribution.LOCAL_SHUFFLE, 65536),
    (Distribution.LOCAL_SHUFFLE, 65537)])
def test_planner_matches_jax_up_to_the_tile_bound(probing, distr, window):
    """pallas_plan and the dial's guess equal JAX's, except for windows
    between the port's wide-band bound (61,376 at tile 8192) and JAX's
    (65,536, its tile): the port sorts first there (build+probe) where JAX
    takes wide bands (ROADMAP queue 3)."""
    from htm_hashjoin_tpu.joins import common as jcommon
    from htm_hashjoin_tpu_torch.joins import common
    cfg = JoinConfig(data_distr=distr, shuffle_range=window)
    jcfg = jax_cfg(cfg)
    got = common.pallas_plan(cfg, probing=probing)
    want = jcommon.pallas_plan(jcfg, probing=probing)
    if common.WIDE_BAND_MAX < window <= 65536 and \
            distr == Distribution.LOCAL_SHUFFLE:
        assert tuple(want) == (None, False, False, False)
        assert tuple(got) == ((None, True, False, None) if probing
                              else (None, False, False, False))
    else:
        assert tuple(got) == tuple(want)
    assert tuple(common.adaptive_guess_plan(cfg, probing)) == \
        tuple(jcommon.adaptive_guess_plan(jcfg, probing))
    for override in (0, 5, 600, 1 << 30):
        assert tuple(common.pallas_plan(cfg, probing, override)) == \
            tuple(jcommon.pallas_plan(jcfg, probing, override))
    for mx in (0, 100, 8191, 8192):
        assert common.dial_window(mx, 16384) == jcommon.dial_window(mx, 16384)
