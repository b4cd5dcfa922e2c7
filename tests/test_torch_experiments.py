"""The port's single-device entry step and its two planner experiments
against the JAX package's, and the port's own Wisconsin confs.

- ``entry``: the port's step on the CPU gives the same three int64 numbers
  as ``jax.jit`` of ``__graft_entry__.entry()``'s step on the same numpy
  keys (the entry's own 1..2^16, and seeded permutations and sparse
  unique keys); exact.
- ``experiments.adaptive_dial_bench``: each plan's ``htm_join`` line equals
  JAX's ``htm_join`` on the same numpy relations (JAX on its banded engine,
  ``backend="pallas"``, Pallas in interpret mode) in totalMatches,
  inputSum, outputSum, backend and the adaptivePlan's window, presort,
  maxDisplacement and windowEstimate; exact.  ``resorted`` and the
  violations depend on the tile (8192 keys here, 65536 in JAX) and are
  not compared (ROADMAP queue 3).
- ``experiments.radix_crossover``: its lines carry the JAX script's fields,
  both engines' outputs pass the multiset and order checks, and the checks
  catch broken outputs.
- Both experiment scripts and the entry raise without a card when no
  device is given.
- The six shipped confs equal the JAX package's byte for byte, and
  ``chip_smoke.py`` reads them from inside the port.
"""

import dataclasses
import filecmp
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from htm_hashjoin_tpu import config as jconfig
from htm_hashjoin_tpu.joins import htm as jhtm
from htm_hashjoin_tpu.relation import Relation as JRelation
from htm_hashjoin_tpu_torch import entry as pentry
from htm_hashjoin_tpu_torch import wisconsin
from htm_hashjoin_tpu_torch.config import Algo, Distribution, JoinConfig
from htm_hashjoin_tpu_torch.constants import MAXI32
from htm_hashjoin_tpu_torch.data.generators import build_relations
from htm_hashjoin_tpu_torch.experiments import (adaptive_dial_bench as dial,
                                                kernel_launches,
                                                launches_since)
from htm_hashjoin_tpu_torch.experiments import radix_crossover as rx
from htm_hashjoin_tpu_torch.joins import htm
from htm_hashjoin_tpu_torch.relation import Relation, keys_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1 << 16
CONFS = ("no_partition", "independent", "parallel", "radix1", "steal",
         "flatmem")


# --------------------------------------------------------------------------
# entry()
# --------------------------------------------------------------------------

def entry_keys(kind):
    """(R, S) numpy int32 keys of one kind, made once from a seed."""
    rng = np.random.default_rng(11)
    if kind == "entry":
        _, (rk, sk) = __graft_entry__.entry()
        return np.array(rk), np.array(sk)
    if kind == "permutation":
        r = rng.permutation(np.arange(1, N + 1, dtype=np.int32))
        return r, rng.permutation(r)
    # unique keys over 1..2^20: bucket wraps make optimistic inserts fail,
    # the claim rounds place them and the residue spills
    r = (rng.choice(1 << 20, N, replace=False) + 1).astype(np.int32)
    s = np.concatenate([r[: N // 2], rng.integers(1, 1 << 20, N // 2,
                                                  dtype=np.int32)])
    return r, s


def jax_entry(rk, sk):
    fn, _ = __graft_entry__.entry()
    return tuple(int(x) for x in jax.jit(fn)(jnp.asarray(rk), jnp.asarray(sk)))


@pytest.mark.parametrize("kind", ["entry", "permutation", "sparse_unique"])
def test_entry_matches_jax(kind):
    rk, sk = entry_keys(kind)
    fn, _ = pentry.entry(device="cpu")
    out = fn(torch.from_numpy(rk), torch.from_numpy(sk))
    assert all(x.dtype == torch.int64 and x.dim() == 0 for x in out)
    got = tuple(int(x) for x in out)
    assert got == jax_entry(rk, sk)
    if kind == "sparse_unique":
        assert got[2] > 0          # the retry and spill really ran


def test_entry_gives_the_expected_numbers():
    fn, (rk, sk) = pentry.entry(device="cpu")
    assert rk.device.type == "cpu" and rk.dtype == torch.int32
    assert torch.equal(rk, torch.arange(1, N + 1, dtype=torch.int32))
    assert torch.equal(rk, sk)
    assert tuple(int(x) for x in fn(rk, sk)) == (N, N * (N + 1) // 2, 0)


def test_entry_needs_a_card_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        pentry.entry()
    with pytest.raises(RuntimeError, match="CUDA device"):
        pentry.main()


# --------------------------------------------------------------------------
# the dial
# --------------------------------------------------------------------------

DIAL_LOG2N, DIAL_WINDOW, DIAL_DECLARED, DIAL_CHEAP = 14, 8, 1 << 14, 2
EQUAL = ("totalMatches", "inputSum", "outputSum", "backend")
PLAN = ("window", "presort", "maxDisplacement", "windowEstimate")


def jax_cfg(cfg: JoinConfig):
    """The JAX package's JoinConfig with the same fields, on its banded
    engine."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(JoinConfig)}
    fields["algo"] = jconfig.Algo(cfg.algo.value)
    fields["data_distr"] = jconfig.Distribution(cfg.data_distr.value)
    fields["backend"] = "pallas"
    return jconfig.JoinConfig(**fields)


def dial_relations():
    """The dial's config, its three plans, and the same relations for both
    packages (port R, port S, JAX R, JAX S)."""
    cfg0 = JoinConfig(algo=Algo.HTM, r_size=1 << DIAL_LOG2N,
                      data_distr=Distribution.LOCAL_SHUFFLE,
                      shuffle_range=DIAL_WINDOW, enable_probe=True, seed=7)
    r, s = build_relations(cfg0)
    rk, sk = r.to_numpy(), s.to_numpy()
    return (cfg0, dial.plan_configs(cfg0, DIAL_DECLARED, DIAL_CHEAP),
            Relation(keys_from_numpy(rk)),
            Relation(keys_from_numpy(sk), assume_sorted=s.assume_sorted),
            JRelation(jnp.asarray(rk)),
            JRelation(jnp.asarray(sk), assume_sorted=s.assume_sorted))


@pytest.mark.parametrize("plan", dial.PLANS)
def test_dial_plan_matches_jax(plan):
    _, cfgs, r, s, jr, js = dial_relations()
    got = htm.htm_join(r, s, cfgs[plan]).to_dict()
    want = jhtm.htm_join(jr, js, jax_cfg(cfgs[plan])).to_dict()
    for key in EQUAL:
        assert got.get(key) == want.get(key), key
    assert got["totalMatches"] == 1 << DIAL_LOG2N
    assert ("adaptivePlan" in got) == ("adaptivePlan" in want) == (
        plan == "adaptive")
    lines = dial.run_plans(r, s, {plan: cfgs[plan]}, reps=2, echo=False)
    assert [d["rep"] for d in lines] == [0, 1]
    for d in lines:
        assert set(d) == {"plan", "rep", "timeUs", "engineTimeUs",
                          "resorted", "adaptivePlan", "launches"}
        assert d["plan"] == plan and d["launches"] == {}   # plain versions
        assert d["resorted"] == got["resorted"]
        if plan == "adaptive":
            for key in PLAN:
                assert d["adaptivePlan"][key] == \
                    want["adaptivePlan"][key], key
        else:
            assert d["adaptivePlan"] is None


def test_dial_plans_take_their_routes():
    """The plans the experiment is about: the declared window takes the
    wide band (2^14 <= WIDE_BAND_MAX here; 2^20 at the defaults takes the
    sort-first plan), the cheap window retries, adaptive dials the
    window-512 sorter from a sniffed displacement within the data's."""
    cfg0, cfgs, r, s, _, _ = dial_relations()
    lines = {d["plan"]: d for d in dial.run_plans(r, s, cfgs, reps=1,
                                                  echo=False)}
    assert lines["fixed-declared"]["resorted"] is False
    assert lines["fixed-cheap"]["resorted"] is True
    plan = lines["adaptive"]["adaptivePlan"]
    assert plan["window"] == 512 and plan["presort"] is False
    assert 0 < plan["windowEstimate"] <= DIAL_WINDOW
    big = dial.plan_configs(cfg0, 1 << 20, DIAL_CHEAP)
    assert big["fixed-declared"].shuffle_range == 1 << 20
    assert big["adaptive"].adaptive and not big["fixed-cheap"].adaptive


def test_dial_raises_on_a_wrong_match_count():
    _, cfgs, r, s, _, _ = dial_relations()
    short = Relation(s.keys[1:], assume_sorted=True)
    with pytest.raises(AssertionError, match="matches"):
        dial.run_plans(r, short, {"adaptive": cfgs["adaptive"]}, reps=1,
                       echo=False)


@pytest.mark.parametrize("times,beats", [((5.0, 6.0, 4.0), True),
                                         ((5.0, 6.0, 5.5), False),
                                         ((5.0, 3.0, 4.0), False)])
def test_dial_summary_takes_warm_medians(times, beats):
    lines = []
    for name, t in zip(dial.PLANS, times):
        for rep, us in enumerate((1000.0, t, t + 1, t - 0.5)):
            lines.append({"plan": name, "rep": rep, "timeUs": us,
                          "launches": {"fused_sort_count": rep}})
    res = dial.summary(lines)
    assert res["adaptiveBeatsBoth"] is beats
    for name, t in zip(dial.PLANS, times):
        d = res["plans"][name]
        assert d["warmMedianUs"] == t        # rep 0 (the build) left out
        assert d["bestUs"] == t - 0.5 and d["launches"] == {
            "fused_sort_count": 3}


def test_dial_main_writes_its_log(tmp_path, capsys):
    out = tmp_path / "adaptive_dial_log"
    assert dial.main(["--log2n", "13", "--window", "8", "--declared",
                      str(1 << 13), "--cheapWindow", "2", "--reps", "2",
                      "--device", "cpu", "--out", str(out)]) == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [(d["plan"], d["rep"]) for d in lines] == [
        (p, i) for p in dial.PLANS for i in range(2)]
    text = capsys.readouterr().out
    assert "# adaptive beats both fixed plans:" in text
    assert text.count("warm median") == 3


def test_launch_counts_since():
    before = kernel_launches()
    assert set(before) == {"fused_sort_count", "sort_tiles",
                           "global_sort_tiles", "banded_count",
                           "banded_count_narrow", "scatter_tiles",
                           "sort_kv_tiles", "global_sort_kv_tiles",
                           "claim_insert", "hash_probe", "rot_pack",
                           "rot_unpack", "multijoin_probe"}
    assert launches_since(before) == {}
    before["sort_tiles"] -= 2
    assert launches_since(before) == {"sort_tiles": 2}


# --------------------------------------------------------------------------
# the crossover
# --------------------------------------------------------------------------

def test_crossover_lines_and_checks():
    lines = rx.crossover([13, 14], reps=1, radix_bits=14, device="cpu",
                         echo=False)
    assert [(d["engine"], d["log2n"]) for d in lines] == [
        (e, lg) for lg in (13, 14) for e in rx.ENGINES]
    for d in lines:
        assert set(d) == {"engine", "log2n", "timeUs", "radixBits",
                          "mtuples_per_s"}
        assert d["radixBits"] == 14 and d["timeUs"] > 0
        assert d["mtuples_per_s"] == (1 << d["log2n"]) / d["timeUs"]
    assert set(rx.ratios(lines)) == {13, 14}


@pytest.mark.parametrize("engine", rx.ENGINES)
@pytest.mark.parametrize("fault", ["none", "swap", "drop", "duplicate"])
def test_crossover_checks_catch_broken_outputs(engine, fault):
    lg = 14
    keys = torch.from_numpy(np.random.default_rng(3).permutation(
        np.arange(1, (1 << lg) + 1, dtype=np.int32)))
    out, shift = rx.run_engine(engine, keys, lg, 14)
    real = torch.nonzero(out != MAXI32).flatten()
    out = out.clone()
    if fault == "swap":       # two keys of one tile out of order
        i, j = int(real[5]), int(real[6])
        out[i], out[j] = out[j].clone(), out[i].clone()
    elif fault == "drop":
        out[int(real[100])] = MAXI32
    elif fault == "duplicate":
        out[int(real[100])] = out[int(real[101])]
    if fault == "none":
        rx.check_output(engine, keys, out, shift)
    else:
        with pytest.raises(AssertionError):
            rx.check_output(engine, keys, out, shift)


def test_crossover_region_order_is_checked():
    """A tile-sorted output whose regions are out of value order (the
    first two tiles swapped) fails the multipass check."""
    lg = 14
    keys = torch.arange(1, (1 << lg) + 1, dtype=torch.int32)
    out, shift = rx.run_engine("multipass", keys, lg, 8)
    tiles = out.view(-1, 8192).clone()
    tiles[[0, 1]] = tiles[[1, 0]]
    with pytest.raises(AssertionError, match="regions"):
        rx.check_output("multipass", keys, tiles.reshape(-1), shift)


def test_crossover_main_writes_its_log(tmp_path, capsys):
    out = tmp_path / "radix_crossover_log"
    assert rx.main(["--sizes", "13", "--reps", "1", "--device", "cpu",
                    "--out", str(out)]) == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [d["engine"] for d in lines] == list(rx.ENGINES)
    assert "# 2^13: multipass/sort = " in capsys.readouterr().out


@pytest.mark.parametrize("script", [dial, rx])
def test_experiment_needs_a_card_without_a_device(script, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        script.main(["--out", str(tmp_path / "log")])
    assert not (tmp_path / "log").exists()


# --------------------------------------------------------------------------
# the port's own confs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFS)
def test_conf_equals_the_jax_package_byte_for_byte(name):
    ours = os.path.join(wisconsin.CONF_DIR, f"{name}.conf")
    theirs = os.path.join(ROOT, "htm_hashjoin_tpu", "wisconsin", "conf",
                          f"{name}.conf")
    assert filecmp.cmp(ours, theirs, shallow=False)


def test_the_port_ships_exactly_the_six_confs():
    assert sorted(os.listdir(wisconsin.CONF_DIR)) == sorted(
        f"{n}.conf" for n in CONFS)
    port = os.path.join(ROOT, "htm_hashjoin_tpu_torch")
    assert os.path.commonpath([wisconsin.CONF_DIR, port]) == port


def test_chip_smoke_reads_the_port_confs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    port = os.path.realpath(os.path.join(ROOT, "htm_hashjoin_tpu_torch"))
    confs = os.path.realpath(mod.WISCONSIN_CONFS)
    assert os.path.commonpath([confs, port]) == port
    assert all(os.path.exists(os.path.join(confs, f"{n}.conf"))
               for n in mod.CONFS)


def test_chip_smoke_imports_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); import chip_smoke\n"
            "print([m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'htm_hashjoin_tpu' or m.startswith("
            "'htm_hashjoin_tpu.')])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120, cwd=ROOT)
    assert out.stdout.split() == ["[]"]
