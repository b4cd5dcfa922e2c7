"""A join step (an entry) found by name: a cell whose configuration names
a new entry needs only new files (the entry module, its reference, a
configuration and a traffic file) and entries in ``BENCHMARK.json``.  Here
a toy entry, a count of equal int64 keys in two small tables, is written
into a directory of its own, and ``cells`` is pointed at it: the cell
loads, runs, is checked exactly on its own fields, has a control, and
passes the tests that every cell of the benchmark has to pass."""

import json
import shutil

import pytest

from joinbench import cells, control, loop, report

import test_joinbench_cells as cell_tests
import test_joinbench_run as run_tests
from conftest import ROOT

TOY_ENTRY = '''"""A toy entry: the pairs of equal keys in two tables of int64 keys."""

import dataclasses

import torch

from joinbench import gen, loop

TRAFFIC_KEYS = frozenset({"alphabet", "why"})
OFFSET = 1 << 40     # keys above 32 bits, so 32-bit accumulators wrap


def load(config, traffic, extra_argv=()):
    rows = int(extra_argv[0]) if extra_argv else config["rows"]
    return {"rows": rows, "alphabet": traffic["alphabet"]}


def prepare(cell, seed, device):
    return seed


def table_bytes(state):
    return 0


@dataclasses.dataclass
class Tables:
    a: torch.Tensor
    b: torch.Tensor

    @property
    def tuples(self):
        return self.a.numel() + self.b.numel()

    def fingerprint(self):
        return (loop.fingerprint(self.a), loop.fingerprint(self.b))


def make(cell, seed, index, device):
    rows, alphabet = cell.settings["rows"], cell.settings["alphabet"]

    def keys(side):
        rng = gen.generator(seed, device, index, side)
        return OFFSET + torch.randint(0, alphabet, (rows,), generator=rng,
                                      device=device)
    return Tables(keys("a"), keys("b"))


def join(cell, inputs):
    equal = inputs.a[:, None] == inputs.b[None, :]
    return {"matches": int(equal.sum()),
            "keySum": int((equal * inputs.a[:, None]).sum())}
'''

TOY_REFERENCE = '''"""The toy entry's reference: for each key of A, the keys of B equal to
it, by one sort of B."""

import torch

FIELDS = ("matches", "keySum")


def expected(inputs, accumulator=torch.int64):
    keys, counts = torch.unique(inputs.b, return_counts=True)
    at = torch.searchsorted(keys, inputs.a).clamp(max=keys.numel() - 1)
    per_a = torch.where(keys[at] == inputs.a, counts[at], 0)
    return {"matches": int(torch.sum(per_a, dtype=accumulator)),
            "keySum": int(torch.sum(per_a * inputs.a, dtype=accumulator))}
'''

TOY_CELL = "toy_count.pairs"


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """A benchmark of its own in ``tmp_path``: the toy's cell, and a copy
    of a join_step cell whose configuration names no entry."""
    for d in ("configs", "traffic", "entries"):
        (tmp_path / d).mkdir()
    (tmp_path / "entries" / "toy_count.py").write_text(TOY_ENTRY)
    (tmp_path / "entries" / "toy_count_reference.py").write_text(
        TOY_REFERENCE)
    for module in ("join_step.py", "join_step_reference.py"):
        shutil.copy(ROOT / "joinbench" / "entries" / module,
                    tmp_path / "entries")
    (tmp_path / "configs" / "toy_count.json").write_text(json.dumps(
        {"entry": "toy_count", "rows": 4096, "small_argv": ["256"],
         "source": "made up", "assumed": ["a toy"], "reduced": []}))
    (tmp_path / "traffic" / "pairs.json").write_text(json.dumps(
        {"alphabet": 64, "why": "a few keys, so many pairs"}))
    adaptive = json.loads(
        (ROOT / "joinbench" / "configs" / "adaptive_2e27.json").read_text())
    assert "entry" not in adaptive
    (tmp_path / "configs" / "plain.json").write_text(json.dumps(adaptive))
    shutil.copy(ROOT / "joinbench" / "traffic" / "shuffle.json",
                tmp_path / "traffic")
    (tmp_path / "configs" / "lost.json").write_text(json.dumps(
        {"entry": "no_such_entry", "small_argv": [], "reduced": []}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = [
        {"name": name, "config": name.split(".")[0],
         "traffic": name.split(".")[1], "chips": 1, "why": "a test"}
        for name in (TOY_CELL, "plain.shuffle", "lost.pairs")]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(cells, "ROOT", tmp_path)
    monkeypatch.setattr(cells, "CONFIGS", tmp_path / "configs")
    monkeypatch.setattr(cells, "TRAFFIC", tmp_path / "traffic")
    monkeypatch.setattr(cells, "ENTRIES", tmp_path / "entries")
    return tmp_path


def _run(name, join_fn=None, extra_argv=("256",)):
    cell = cells.load(name, list(extra_argv))
    return loop.run(cell, 2**31 + 11, 0.05, False, "cpu", 0.0,
                    join_fn=join_fn)


def test_a_new_entry_loads_by_name(toy):
    cell = cells.load(TOY_CELL)
    assert cell.entry.__file__ == str(toy / "entries" / "toy_count.py")
    assert cell.reference.__file__ == str(
        toy / "entries" / "toy_count_reference.py")
    assert cell.settings == {"rows": 4096, "alphabet": 64}
    assert cell.limits == {"matches_gap": 0, "keySum_gap": 0}
    assert cells.load(TOY_CELL, ["256"]).settings["rows"] == 256


# the tests every cell of BENCHMARK.json is put through, on the toy's cell
EVERY_CELL = [cell_tests.test_every_cell_loads_by_name_and_reports_enough,
              run_tests.test_a_small_run_is_correct_and_reports_every_metric,
              run_tests.test_a_traced_run_reports_the_lines_counter,
              run_tests.test_the_control_is_not_correct]


@pytest.mark.parametrize("test", EVERY_CELL, ids=lambda t: t.__name__)
def test_a_new_entry_passes_every_cell_s_tests(toy, test):
    test(TOY_CELL)


def test_a_new_entry_runs_correct_with_its_own_gaps(toy, capsys):
    run = _run(TOY_CELL)
    out = report.result(run, False)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert run.joins[0].tuples == 512 and run.joins[0].line["matches"] > 0
    assert set(out["metrics"]) == {m["name"] for m in run.cell.end_to_end}
    report.emit(out)
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-2:] == ["check matches_gap 0 limit 0",
                        "check keySum_gap 0 limit 0"]


def test_a_new_entry_has_a_control(toy):
    run = _run(TOY_CELL, join_fn=control.control_join)
    assert not report.correct(run) and run.check["keySum_gap"] > 0


def test_a_fault_in_a_new_entry_is_caught(toy):
    def one_match_more(cell, inputs):
        line = cell.entry.join(cell, inputs)
        return dict(line, matches=line["matches"] + 1)
    run = _run(TOY_CELL, join_fn=one_match_more)
    assert not report.correct(run) and run.check["matches_gap"] == 1


def test_a_new_entry_s_inputs_must_be_made_again_alike(toy, monkeypatch):
    calls = {"n": 0}
    real = loop.fingerprint

    def drifting(keys):      # no two calls alike
        calls["n"] += 1
        a, b = real(keys)
        return (a + calls["n"], b)
    monkeypatch.setattr(loop, "fingerprint", drifting)
    run = _run(TOY_CELL)
    assert run.failed >= 1 and not report.correct(run)


def test_a_configuration_without_an_entry_runs_join_step(toy):
    cell = cells.load("plain.shuffle")
    assert cell.entry.__file__ == str(toy / "entries" / "join_step.py")
    run = _run("plain.shuffle", extra_argv=("--rSize", str(1 << 17)))
    assert report.correct(run)
    assert set(run.check) == {"totalMatches_gap", "inputSum_gap",
                              "outputSum_gap"}


def test_an_unknown_entry_is_an_error(toy):
    with pytest.raises(FileNotFoundError):
        cells.load("lost.pairs")
    with pytest.raises(FileNotFoundError):
        cells.entry_module("no_such_entry")


def test_an_entry_without_its_reference_is_an_error(toy):
    (toy / "entries" / "toy_count_reference.py").unlink()
    with pytest.raises(FileNotFoundError):
        cells.load(TOY_CELL)
