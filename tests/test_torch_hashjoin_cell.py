"""The benchmark's hash-table cell (``hashjoin_2e27.shuffle``: the global
atomic table, ``--algo atomic --backend xla``) on the CPU, held to the
benchmark's plain reference (``joinbench/reference.py``) at |R| = 2^16: on
the cell's traffic (R shuffled, S sorted), on sorted R, and on R of 4096
distinct keys, whose copies exhaust the probe budget, so that the spill is
filled and probed.  Then the benchmark's own loop on the cell, correct."""

import time

import pytest
import torch

from joinbench import cells, loop, reference, report
from htm_hashjoin_tpu_torch.joins import DISPATCH
from htm_hashjoin_tpu_torch.relation import Relation

CPU = torch.device("cpu")
SEED = 2**31 + 29
N = 1 << 16
DISTINCT = 4096


def cell(extra=()):
    return cells.load("hashjoin_2e27.shuffle", ["--rSize", str(N), *extra])


def relations(kind):
    """(argv for the planner, r, s) of one input kind."""
    if kind == "cell":
        r, s = loop.Inputs(cell(), SEED, CPU).pair(0)
        return [], r, s
    s = Relation(torch.arange(1, N + 1, dtype=torch.int32),
                 assume_sorted=True)
    if kind == "sorted":
        return ["--dataDistr", "sorted"], Relation(s.keys.clone()), s
    g = torch.Generator().manual_seed(SEED)
    r = torch.randint(1, DISTINCT + 1, (N,), generator=g, dtype=torch.int32)
    return (["--dataDistr", "uniform", "--distinctKeys", str(DISTINCT)],
            Relation(r), s)


@pytest.mark.parametrize("kind", ["cell", "sorted", "duplicates"])
def test_the_atomic_table_equals_the_reference(kind):
    argv, r, s = relations(kind)
    cfg = cell(argv).cfg
    assert (cfg.algo.value, cfg.backend) == ("atomic", "xla")
    line = DISPATCH["atomic"](r, s, cfg).to_dict()
    want = reference.expected(r.keys, s.keys)
    assert {f: line[f] for f in reference.FIELDS} == want
    assert line["claimRows"] == 4 * N and line["sortedKeys"] == 0
    if kind == "duplicates":
        # 16 copies a key on average against a budget of 4 slots
        assert line["conflicts"] > 0
        # and the spill's: its sort's fence, its probe's fence and readback
        assert line["readbacks"] == 7
    else:
        assert line["conflicts"] == 0 and line["readbacks"] == 4


def test_the_cells_loop_on_the_cpu_is_correct():
    run = loop.run(cell(), SEED, 0.05, False, "cpu", time.perf_counter())
    out = report.result(run, False)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert all(v["value"] == 0 for v in out["check"].values())
    assert all(j.line["claimRows"] == 4 * N for j in run.joins)
