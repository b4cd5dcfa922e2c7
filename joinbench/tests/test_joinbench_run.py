"""A run end to end on the CPU at small sizes (the port's plain versions):
the harness's look for a card is skipped, the rest is the run's own.  The
check comes out correct for the program, and false for the control and
for each fault a join can have."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from joinbench import cells, control, loop, report

from conftest import CELLS, JOIN_STEP_CELLS, ROOT, cpu_run, small_cell


@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_is_correct_and_reports_every_metric(name):
    run = cpu_run(name)
    out = report.result(run, False)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "check"
    want = {m["name"] for m in cells.load(name).end_to_end}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for k, v in out["metrics"].items()
               if k != "peak_gib")     # no device memory on the CPU
    assert all(v["value"] == 0 and v["limit"] == 0
               for v in out["check"].values())


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_the_lines_counter(name):
    # long enough for a second join on a loaded CPU: the first carries the
    # profiler's start-up and is not read
    run = cpu_run(name, traced=True, seconds=1.0)
    out = report.result(run, True)
    assert out["correct"]
    assert len(run.traced) == min(loop.TRACED, len(run.joins) - 1)
    assert "replan_share" in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


def test_the_replan_share_of_each_cell():
    share = {name: report.metrics(cpu_run(name), [
        {"name": "replan_share", "unit": "%"}])["replan_share"]["value"]
        for name in CELLS}
    assert share["pro_2e24x2e28.fk_uniform"] == 0
    assert share["adaptive_2e27.shuffle"] == 100


def test_each_join_gets_fresh_inputs():
    cell = small_cell("adaptive_2e27.shuffle")
    inputs = loop.Inputs(cell, 9, "cpu")
    a, b = inputs.pair(0), inputs.pair(1)
    assert not torch.equal(a[0].keys, b[0].keys)
    assert torch.equal(a[0].keys, inputs.pair(0)[0].keys)
    assert a[1].assume_sorted and not a[0].assume_sorted
    s = small_cell("pro_2e24x2e28.fk_zipf1")
    assert not loop.Inputs(s, 9, "cpu").pair(0)[1].assume_sorted


def _faulty(change):
    """The port's join step with ``change`` applied where it is produced,
    in the place of the entry's (``join_step``'s) call."""
    def join(cell, inputs):
        from htm_hashjoin_tpu_torch.joins import DISPATCH
        cfg = cell.settings["cfg"]
        return change(DISPATCH[cfg.algo.value], inputs.r, inputs.s,
                      cfg).to_dict()
    return join


def _line_edit(field, delta):
    def change(fn, r, s, cfg):
        m = fn(r, s, cfg)
        setattr(m, field, getattr(m, field) + delta)
        return m
    return change


def _half(side):
    def change(fn, r, s, cfg):
        from htm_hashjoin_tpu_torch.relation import Relation
        if side == "r":
            r = Relation(r.keys[: r.num_tuples // 2])
        else:
            s = Relation(s.keys[: s.num_tuples // 2],
                         assume_sorted=s.assume_sorted)
        return fn(r, s, cfg)
    return change


def _raise(fn, r, s, cfg):
    raise RuntimeError("planted fault")


FAULTS = {
    "one match added": _line_edit("totalMatches", 1),
    "a build key lost": _line_edit("outputSum", -1),
    "an input key miscounted": _line_edit("inputSum", 1),
    "half of S left out": _half("s"),
    "half of R left out": _half("r"),
    "the join raises": _raise,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["adaptive_2e27.shuffle",
                                  "pro_2e24x2e28.fk_zipf1"])
def test_a_fault_makes_the_run_not_correct(name, fault):
    run = cpu_run(name, join_fn=_faulty(FAULTS[fault]))
    assert not report.correct(run)
    assert run.failed >= 1


def test_inputs_not_made_again_alike_fail_the_check(monkeypatch):
    calls = {"n": 0}
    real = loop.fingerprint

    def drifting(keys):
        calls["n"] += 1
        a, b = real(keys)
        return (a + (calls["n"] > 2), b)
    monkeypatch.setattr(loop, "fingerprint", drifting)
    run = cpu_run("adaptive_2e27.shuffle")
    assert run.failed >= 1 and not report.correct(run)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    run = cpu_run(name, join_fn=control.control_join)
    assert not report.correct(run)
    assert any(run.check[k] > lim for k, lim in run.cell.limits.items())


@pytest.mark.parametrize("name", JOIN_STEP_CELLS)
def test_the_join_step_control_wraps_both_sums(name):
    run = cpu_run(name, join_fn=control.control_join)
    assert not report.correct(run)
    assert run.check["inputSum_gap"] > 0 and run.check["outputSum_gap"] > 0


def test_the_generators_tables_are_left_out_of_the_peak():
    zipf = small_cell("pro_2e24x2e28.fk_zipf1")
    r_size = zipf.settings["r_size"]
    assert loop.Inputs(zipf, 9, "cpu").table_bytes == r_size * 8
    plain = small_cell("adaptive_2e27.shuffle")
    assert loop.Inputs(plain, 9, "cpu").table_bytes == 0
    run = cpu_run("pro_2e24x2e28.fk_zipf1")
    assert run.table_bytes == r_size * 8
    out = report.result(run, False)
    assert out["device"]["memory_peak_bytes"] == (
        max(j.peak_bytes for j in run.joins) + run.table_bytes)


def test_the_control_fails_without_a_card():
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run(
        [sys.executable, "joinbench/control.py", "--workload", CELLS[0],
         "--seeds", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=env)
    assert done.returncode != 0 and not done.stdout.strip()
    assert "CUDA device" in done.stderr


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "joinbench/run.py", "--workload", CELLS[0],
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def _printed_a_result(done):
    for line in done.stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return True
        except (ValueError, TypeError):
            pass
    return False


def test_the_command_fails_without_a_card():
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = _command(ROOT, env)
    assert done.returncode != 0 and not _printed_a_result(done)
    assert "CUDA device" in done.stderr


def test_the_command_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "joinbench", tmp_path / "joinbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = _command(tmp_path)
    assert done.returncode != 0 and not _printed_a_result(done)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(cuda, name):
    done = subprocess.run(
        [sys.executable, "joinbench/run.py", "--workload", name, "--seed",
         str(2**31 + 17), "--seconds", "2", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0
    assert done.stderr.strip().splitlines()[-1].startswith("check ")
