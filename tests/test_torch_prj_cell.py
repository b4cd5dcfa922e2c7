"""The benchmark's radix-partition cell (``prj_2e24x2e28.fk_uniform``:
Workload A through PRO's two-pass, 14-bit multipass partition, ``--algo PRO
--radixStrategy multipass``) on the CPU at its configuration's
``small_argv`` (2^17 ⋈ 2^19), held exactly to the ``join_step`` entry's
plain reference (``joinbench/reference.py``).  Also: the CLI flag, the
partition's digits taken over R's key range where |S| > |R|, the
benchmark's own loop on the cell (correct, and not correct under planted
faults and the control), and the cell's two readers
(``radix_partition_roofline``, ``partition_pad_ratio``) on made-up traced
joins and lines."""

import time
import types

import pytest
import torch

from joinbench import cells, control, loop, peaks, report, trace
from htm_hashjoin_tpu_torch import cli
from htm_hashjoin_tpu_torch.config import Algo, Distribution, JoinConfig
from htm_hashjoin_tpu_torch.data.generators import build_relations
from htm_hashjoin_tpu_torch.joins import radix
from htm_hashjoin_tpu_torch.ops.radix_kernels import plan_passes
from htm_hashjoin_tpu_torch.relation import Relation
from htm_hashjoin_tpu_torch.utils.metrics import MULTIPASS_ONLY_FIELDS

CPU = torch.device("cpu")
NAME = "prj_2e24x2e28.fk_uniform"
CONFIG = "prj_2e24x2e28"
SEEDS = [2**31 + 43, 2**32 + 11, 5]
# the pass output at |R| = 2^17, tile 8192: pass 1 writes 13,184 rows of
# 128 keys, pass 2 206 x 64 + 206 x 128 + 16,384 x 16 = 301,696 rows
SMALL_PARTITIONED = 301_696 * 128


def cell():
    return cells.load(NAME, cells.config_file(CONFIG)["small_argv"])


@pytest.mark.parametrize("strategy", ["auto", "sort", "multipass"])
def test_the_flag_parses_into_radix_strategy(strategy):
    cfg, _ = cli.parse_args(["--algo", "PRO", "--radixStrategy", strategy])
    assert cfg.radix_strategy == strategy
    assert cli.parse_args(["--algo", "PRO"])[0].radix_strategy == "auto"
    with pytest.raises(SystemExit):
        cli.parse_args(["--radixStrategy", "scatter"])


def test_the_cells_argv_reaches_the_multipass_plan():
    """The configuration at its own sizes, planned without a join: the
    digits over R's 2^24 keys (25 bits) give shifts 18 and 11; over both
    sides' 2^28 (29 bits) they would give 22 and 15."""
    cfg = cells.load(NAME).cfg
    assert (cfg.algo, cfg.radix_strategy) == (Algo.RADIX, "multipass")
    assert (cfg.radix_bits, cfg.radix_passes) == (14, 2)
    assert (cfg.r_size, cfg.s_size) == (1 << 24, 1 << 28)
    bits = radix._build_key_bound(cfg).bit_length()
    assert bits == 25
    assert plan_passes(bits, 14, 2) == [(18, 7), (11, 7)]
    assert plan_passes(radix._max_key_bound(cfg).bit_length(), 14, 2) == \
        [(22, 7), (15, 7)]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_cell_equals_the_reference(seed):
    c = cell()
    inputs = c.entry.make(c, c.entry.prepare(c, seed, CPU), 0, CPU)
    want = c.reference.expected(inputs)
    line = c.entry.join(c, inputs)
    assert {f: line[f] for f in c.reference.FIELDS} == want
    assert want["totalMatches"] == c.settings["s_size"]
    assert line["backend"] == "pallas_multipass_radix"
    assert (line["numPasses"], line["fanout"]) == (2, 1 << 14)
    # R's 2^17 keys need 18 bits
    assert line["passBits"] == [7, 7] and line["passShifts"] == [11, 4]
    assert set(line) >= MULTIPASS_ONLY_FIELDS
    assert line["partitionedKeys"] == SMALL_PARTITIONED
    assert line["totalOverflows"] == 0
    # the two fences, the probe's count and the line's key sums
    assert line["readbacks"] == 4
    assert line["sortedKeys"] == c.settings["s_size"]    # K3 sorts S only


def _multipass(r_size, s_size, seed=3):
    cfg = JoinConfig(algo=Algo.RADIX, r_size=r_size, s_size=s_size,
                     data_distr=Distribution.PK, s_distr=Distribution.FK,
                     radix_bits=8, radix_passes=2,
                     radix_strategy="multipass", seed=seed)
    r, s = build_relations(cfg, CPU)
    return r, radix.radix_join(r, s, cfg).to_dict()


def test_the_digits_cover_the_build_sides_range():
    """|S| = 16 |R|: the digits are R's, as where |S| = |R|.  Over both
    sides' range (19 bits for 2^18 keys) the 8 bits would put R's 2^14
    keys in 9 partitions of 2^11 values, each wider than the 2048-key
    tile."""
    n = 1 << 14
    r, wide = _multipass(n, 16 * n)
    _, same = _multipass(n, n)
    assert wide["passShifts"] == same["passShifts"] == [11, 7]
    assert wide["passBits"] == same["passBits"] == [4, 4]

    def partitions(line):
        return torch.unique(r.keys >> line["passShifts"][-1]).numel()
    assert partitions(wide) == partitions(same) == (n >> 7) + 1
    assert torch.unique(r.keys >> 11).numel() == 9     # the wider digits
    assert wide["totalMatches"] == 16 * n and same["totalMatches"] == n
    assert wide["inputSum"] == wide["outputSum"] == n * (n + 1) // 2
    assert wide["totalOverflows"] == 0


def test_the_cells_loop_on_the_cpu_is_correct():
    run = loop.run(cell(), SEEDS[0], 0.05, False, "cpu", time.perf_counter())
    out = report.result(run, False)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert all(v["value"] == 0 and v["limit"] == 0
               for v in out["check"].values())
    assert all(j.line["partitionedKeys"] == SMALL_PARTITIONED
               for j in run.joins)


def _drop_an_r_key(c, inputs):
    inputs.r = Relation(inputs.r.keys[1:])
    return c.entry.join(c, inputs)


def _lose_a_match(c, inputs):
    real = radix.banded_probe

    def probe(*args, **kwargs):
        matches, overflow = real(*args, **kwargs)
        return matches - 1, overflow
    radix.banded_probe = probe
    try:
        return c.entry.join(c, inputs)
    finally:
        radix.banded_probe = real


FAULTS = {
    "an R key dropped from the build": (_drop_an_r_key,
                                        {"totalMatches_gap", "inputSum_gap",
                                         "outputSum_gap"}),
    "a match lost": (_lose_a_match, {"totalMatches_gap"}),
    "the control": (control.control_join, {"inputSum_gap",
                                           "outputSum_gap"}),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_makes_the_run_not_correct(fault):
    join_fn, gaps = FAULTS[fault]
    run = loop.run(cell(), SEEDS[1], 0.05, False, "cpu", time.perf_counter(),
                   join_fn=join_fn)
    assert not report.correct(run) and run.failed >= 1
    assert {k for k, v in run.check.items() if v} == gaps


US = 1e-6


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _traced_run(port_spans=True, partitioned=(11_000, 13_000)):
    """Two made-up traced joins of [0, 300) us over |R| = 1000 in two
    passes.  Inside hj.partition [2, 100): a K2 [5, 25), a K6 [20, 40) and
    glue [60, 70) (45 busy); a K2 [120, 150) after it, inside hj.build;
    K4 [200, 250) inside hj.probe.  The window's first join is not
    traced, as in a run."""
    events = []
    for t in (0, 1000):
        events += [_x("user_annotation", trace.JOIN_SPAN, t, 300),
                   _x("kernel", "sort_tiles_kernel<8192>", t + 5, 20),
                   _x("kernel", "scatter_tiles_kernel", t + 20, 20),
                   _x("kernel", "at::native::index_kernel", t + 60, 10),
                   _x("kernel", "sort_tiles_kernel<8192>", t + 120, 30),
                   _x("kernel", "banded_count_kernel<512>", t + 200, 50)]
        if port_spans:
            events += [_x("cpu_op", "hj.join", t + 1, 298),
                       _x("cpu_op", "hj.partition", t + 2, 98),
                       _x("cpu_op", "hj.build", t + 110, 60),
                       _x("cpu_op", "hj.probe", t + 180, 100)]
    lines = [None] + [{"partitionedKeys": p} for p in partitioned]
    joins = [loop.Join(i, 1.0, 0.0, 0, 1500, line, None, ())
             for i, line in enumerate(lines)]
    cfg = types.SimpleNamespace(radix_passes=2)
    return types.SimpleNamespace(
        cell=types.SimpleNamespace(settings=dict(r_size=1000, s_size=500,
                                                 cfg=cfg)),
        joins=joins, traced=trace.reduce(events))


def test_the_cells_readers_on_made_up_traced_joins_and_lines():
    run = _traced_run()

    def read(name, r=run):
        return cells.metric_module(name).read(r)
    roofline = 100 * 2 * 8 * 2 * 1000 / peaks.HBM_BYTES_PER_S / (2 * 45 * US)
    assert read("radix_partition_roofline") == pytest.approx(roofline)
    assert read("partition_pad_ratio") == pytest.approx(12.0)
    three = _traced_run()
    three.cell.settings["cfg"].radix_passes = 3
    assert read("radix_partition_roofline", three) == pytest.approx(
        roofline * 3 / 2)
    # a program without the span or the counter, or a run without a
    # trace, reads nothing
    bare = _traced_run(port_spans=False, partitioned=())
    untraced = types.SimpleNamespace(cell=run.cell, joins=run.joins,
                                     traced=None)
    assert read("radix_partition_roofline", bare) is None
    assert read("radix_partition_roofline", untraced) is None
    assert read("partition_pad_ratio", bare) is None
    run.joins[1].line = None                  # a join that failed
    assert read("partition_pad_ratio") == pytest.approx(13.0)


def test_the_cell_reports_its_readers():
    c = cells.load(NAME)
    names = {m["name"] for m in c.per_layer}
    assert {"radix_partition_roofline", "partition_pad_ratio"} <= names
    assert not {"k3_roofline", "sorted_keys_ratio", "split_roofline"} & names
    assert c.chips == 1 and c.config["reduced"] == []
