"""The port's observability layer (``utils/profiler.py``, ``utils/timing.py``
and the ``--counters`` model of ``joins/common.py``) against the JAX
package's: throughput reports, counter configs and events, syncstats, the
plan traffic model (JAX's on every plan without a global sort; the port's
radix sort model where one runs), the timed phases' counters, the lines
of the banded engine's joins, and a torch.profiler trace on the CPU."""

import glob
import itertools
import os

import numpy as np
import pytest
import torch

from htm_hashjoin_tpu.utils import profiler as jprofiler
from htm_hashjoin_tpu_torch.config import Algo, Distribution, JoinConfig
from htm_hashjoin_tpu_torch.data.generators import build_relations
from htm_hashjoin_tpu_torch.joins import common
from htm_hashjoin_tpu_torch.joins.banded_backend import DEFAULT_TILE
from htm_hashjoin_tpu_torch.utils import profiler
from htm_hashjoin_tpu_torch.utils.timing import PhaseTimer

ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG_FILES = [os.path.join(ROOT, pkg, "utils", "profiler.cfg")
             for pkg in ("htm_hashjoin_tpu", "htm_hashjoin_tpu_torch")]


@pytest.fixture
def counters_off():
    """Both packages' counter sessions off before and after the test."""
    profiler.disable_counters()
    jprofiler.disable_counters()
    yield
    profiler.disable_counters()
    jprofiler.disable_counters()


@pytest.mark.parametrize("clock", [None, "1.75", "0"])
@pytest.mark.parametrize("n,micros", [(1_000_000, 10_000.0), (1000, 1.0),
                                      (0, 5.0), (4096, 0.0)])
def test_throughput_report_equals_jax(monkeypatch, clock, n, micros):
    """JAX's fields, whatever the JAX package's clock variable says; only
    its cyclesPerTuple is not reported (the card has no fixed clock)."""
    if clock is None:
        monkeypatch.delenv("TPU_CLOCK_GHZ", raising=False)
    else:
        monkeypatch.setenv("TPU_CLOCK_GHZ", clock)
    got = profiler.throughput_report(n, micros)
    want = jprofiler.throughput_report(n, micros)
    assert ("cyclesPerTuple" in want) == (clock == "1.75")
    want.pop("cyclesPerTuple", None)
    assert got == want
    assert list(got) == ["numTuples", "totalTimeUsecs", "nsPerTuple",
                         "tuplesPerSecond"]


@pytest.mark.parametrize("path", CFG_FILES,
                         ids=["jax profiler.cfg", "port profiler.cfg"])
def test_counters_from_either_config_file_equal_jax(path):
    pc = profiler.PerfCounters.from_config(path)
    assert pc.events == jprofiler.PerfCounters.from_config(path).events
    assert pc.events == profiler.PerfCounters.DEFAULT_EVENTS
    assert pc.events == jprofiler.PerfCounters.DEFAULT_EVENTS


EVENTS = {"mem_bytes": "bytes accessed", "ai": "arithmetic_intensity",
          "bw": "hbm_gbps", "f": "flops", "l3_misses": "L3 misses"}


@pytest.mark.parametrize("events", [None, EVENTS], ids=["default", "custom"])
@pytest.mark.parametrize("byts,micros,flops", [
    (4.0 * (1 << 27), 2300.0, 0.0), (1e6, 0.0, 0.0), (0.0, 100.0, 0.0),
    (2048.0, 3.5, 512.0)])
def test_traffic_counters_equal_jax(counters_off, events, byts, micros,
                                    flops):
    assert profiler.traffic_counters(byts, micros, flops) is None
    profiler.enable_counters(profiler.PerfCounters(events))
    jprofiler.enable_counters(jprofiler.PerfCounters(events))
    assert profiler.traffic_counters(byts, micros, flops) == \
        jprofiler.traffic_counters(byts, micros, flops)


def test_config_file_events_read_unknown_keys_as_zero(tmp_path):
    cfg = tmp_path / "events.cfg"
    cfg.write_text("# comment\n\nmyflops=flops\nai=arithmetic_intensity\n"
                   "dtlb = DTLB misses\n")
    pc = profiler.PerfCounters.from_config(str(cfg))
    assert pc.events == jprofiler.PerfCounters.from_config(str(cfg)).events
    x = torch.ones(1 << 10)
    out = pc.measure(lambda a: a * 2.0, x, micros=10.0)
    assert out == {"myflops": 0.0, "ai": 0.0, "dtlb": 0.0}


def test_measure_counts_the_tensors_taken_and_returned():
    x, y = torch.ones(1 << 12), torch.zeros(100, dtype=torch.int64)
    pc = profiler.PerfCounters()
    out = pc.measure(lambda a, b=None: (a + 1, [b]), x, b=y, micros=100.0)
    byts = 2 * 4 * (1 << 12) + 2 * 8 * 100
    assert out == {"flops": 0.0, "bytes": byts, "intensity": 0.0,
                   "bandwidth": pytest.approx(byts / 100e-6 / 1e9)}
    assert pc.measure(lambda a: a, x)["bandwidth"] == 0.0


@pytest.mark.parametrize("work", [[100, 10, 10, 10], [50, 50], [], [0, 0],
                                  [3.5, 1.25, 7.0]])
def test_sync_stats_equals_jax(work):
    assert profiler.sync_stats(work) == jprofiler.sync_stats(work)


@pytest.mark.parametrize("hist,n_shards", [
    ([5, 1, 1, 1, 5, 1, 1, 1], 4), ([3, 3, 3], 2), (list(range(17)), 8),
    ([7], 3)])
def test_shard_work_from_histogram_equals_jax(hist, n_shards):
    got = profiler.shard_work_from_histogram(np.array(hist), n_shards)
    want = jprofiler.shard_work_from_histogram(np.array(hist), n_shards)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


PLANS = [common.BandedPlan(*p) for p in itertools.product(
    (None, 16), (False, True), (False, True), (None, False))]


@pytest.mark.parametrize("r_size,s_size", [(1 << 20, 1 << 20),
                                           (1 << 27, 1 << 27),
                                           (4096, 3 * 4096 + 5),
                                           (1000, None)])
def test_plan_traffic_bytes(r_size, s_size):
    """JAX's model wherever no global sort runs; where one does (presort,
    sort_s), K3's radix sort: one histogram read of the keys, then four
    scatter passes reading and writing them, where JAX counts its bitonic
    network's passes."""
    from htm_hashjoin_tpu.config import JoinConfig as JJoinConfig
    from htm_hashjoin_tpu.joins import common as jcommon
    cfg = JoinConfig(r_size=r_size, s_size=s_size)
    jcfg = JJoinConfig(r_size=r_size, s_size=s_size)
    s = cfg.s_size
    assert common.radix_sort_bytes(s) == 4.0 * s * 9
    for plan, probing, sort_s in itertools.product(PLANS, (False, True),
                                                   (False, True)):
        got = common.plan_traffic_bytes(cfg, plan, probing, sort_s)
        jplan = jcommon.BandedPlan(*plan)
        want = jcommon.plan_traffic_bytes(jcfg, jplan, probing, sort_s)
        sorts_r = plan.presort and not plan.presorted
        sorts_s = probing and sort_s
        if not (sorts_r or sorts_s):
            assert got == want, (plan, probing, sort_s)
            continue
        if sorts_r:
            want += 4.0 * r_size * 9 - 2 * 4.0 * r_size * \
                jcommon._gsort_pass_count(r_size)
        if sorts_s:
            want += 4.0 * s * 9 - 2 * 4.0 * s * jcommon._gsort_pass_count(s)
        assert got == want, (plan, probing, sort_s)


def test_timed_phases_record_counters_only_in_a_session(counters_off):
    x = torch.arange(1000, dtype=torch.int32)
    timer = PhaseTimer()
    timer.timed("build", lambda a: (a + 1, a > 3), x)
    assert timer.counters == {}
    profiler.enable_counters()
    timer.timed("probe", lambda a, k=None: a.sum(), x, k=x[:10])
    timer.timed("spill", lambda: None)
    profiler.disable_counters()
    c = timer.counters["probe"]
    assert set(timer.counters) == {"probe", "spill"}
    assert timer.counters["spill"]["bytes"] == 0.0
    assert c["bytes"] == 4000 + 40 + 8 and c["flops"] == 0.0
    assert c["bandwidth"] == pytest.approx(
        c["bytes"] / (timer.micros["probe"] * 1e-6) / 1e9)
    with timer.phase("sniff"):
        pass
    assert timer.micros["sniff"] >= 0
    assert timer.total() == pytest.approx(sum(timer.micros.values()))


@pytest.mark.parametrize("algo,fields,probing", [
    ("atomic", dict(data_distr=Distribution.SHUFFLE), True),
    ("nocc", dict(data_distr=Distribution.LOCAL_SHUFFLE), False),
    ("htm", dict(data_distr=Distribution.SORTED), False),
    ("htm", dict(data_distr=Distribution.LOCAL_SHUFFLE,
                 shuffle_range=4096), True),
    ("htm", dict(data_distr=Distribution.PK, s_distr=Distribution.ZIPF,
                 s_size=1 << 13), True),
    ("npo", dict(data_distr=Distribution.PK, s_distr=Distribution.FK,
                 s_size=1 << 14), True),
    ("radix", dict(data_distr=Distribution.SHUFFLE), True),
    ("sortmerge", dict(data_distr=Distribution.SHUFFLE), True),
    ("htm", dict(data_distr=Distribution.LOCAL_SHUFFLE, adaptive=True),
     True),
], ids=lambda v: v if isinstance(v, str) else None)
def test_banded_lines_carry_their_plans_traffic(counters_off, algo, fields,
                                                probing):
    """The engine's joins put the counters of the plan they ran in the line:
    presorts and S sorts (K3) included."""
    from htm_hashjoin_tpu_torch.joins import DISPATCH
    cfg = JoinConfig(algo=Algo(algo), r_size=1 << 13, enable_probe=probing,
                     **fields)
    r, s = build_relations(cfg, "cpu")
    profiler.enable_counters()
    m = DISPATCH[algo](r, s if probing else None, cfg)
    profiler.disable_counters()
    assert m.extra["backend"] == "pallas_banded"
    (phase, c), = m.extra["counters"].items()
    assert phase == ("build+probe" if probing else "build")
    if algo == "sortmerge":
        plan = common.BandedPlan(None, True, False, None)
    elif algo == "radix":   # presorts only past one tile of S
        plan = common.BandedPlan(None, s.num_tuples > DEFAULT_TILE, False,
                                 None)
    elif cfg.adaptive:
        plan = common.BandedPlan(16, False, False, None)
    else:
        plan = common.pallas_plan(cfg, probing=probing)
    sort_s = probing and not s.assume_sorted
    assert c["bytes"] == common.plan_traffic_bytes(cfg, plan, probing, sort_s)
    assert c["bandwidth"] > 0 and c["flops"] == 0.0
    assert set(c) == set(profiler.PerfCounters.DEFAULT_EVENTS)


def test_scatter_build_lines_carry_their_phases(counters_off):
    from htm_hashjoin_tpu_torch.joins import DISPATCH
    cfg = JoinConfig(algo=Algo.ATOMIC, r_size=1 << 12, backend="xla",
                     data_distr=Distribution.UNIFORM, distinct_keys=500)
    r, s = build_relations(cfg, "cpu")
    m = DISPATCH["atomic"](r, s, cfg)
    assert "counters" not in m.extra
    profiler.enable_counters()
    m = DISPATCH["atomic"](r, s, cfg)
    profiler.disable_counters()
    phases = m.extra["counters"]
    assert {"build", "probe"} <= set(phases)
    assert phases["build"]["bytes"] >= 4 * (1 << 12)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    d = str(tmp_path / "prof")
    with profiler.trace(d):
        torch.arange(1 << 12).sort()
    files = glob.glob(os.path.join(d, "*.pt.trace.json*"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    assert "aten::sort" in open(files[0]).read()
