"""Discovery by name, and BENCHMARK.json against the benchmark's contract."""

import json
import re

import pytest

from joinbench import cells, gen

from conftest import CELLS, JOIN_STEP_CELLS, ROOT

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "joinbench/run.py"]
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"joinbench/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(key) for key in c["reduced"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]
        assert body["source"] == c["source"]
        assert body["assumed"]
        assert isinstance(body["small_argv"], list)
        assert all(isinstance(a, str) for a in body["small_argv"])
        entry = body.get("entry", cells.DEFAULT_ENTRY)
        assert NAME.match(entry)
        for module in (entry, f"{entry}_reference"):
            assert (ROOT / "joinbench" / "entries"
                    / f"{module}.py").is_file()


def test_workloads():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] == 1 and _line(w["why"])


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    all_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(all_names) == len(set(all_names))


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name_and_reports_enough(name):
    cell = cells.load(name)
    assert cell.limits == {f"{f}_gap": 0 for f in cell.reference.FIELDS}
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader_that_agrees(entry):
    mod = cells.metric_module(entry["name"])
    assert callable(mod.read) and mod.__doc__
    assert mod.UNIT == entry["unit"]
    if "layer" in entry:
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])


def _entries_reading(traffic):
    """The entries of the cells on ``traffic``; a mix no cell runs is kept
    for ``join_step``."""
    names = {cells.config_file(w["config"]).get("entry", cells.DEFAULT_ENTRY)
             for w in BENCH["workloads"] if w["traffic"] == traffic}
    return names or {cells.DEFAULT_ENTRY}


def test_every_traffic_names_its_generators():
    for path in sorted((ROOT / "joinbench" / "traffic").glob("*.json")):
        t = json.loads(path.read_text())
        assert _line(t["why"])
        for entry in _entries_reading(path.stem):
            assert set(t) == cells.entry_module(entry).TRAFFIC_KEYS
        if _entries_reading(path.stem) == {"join_step"}:
            for side in "rs":
                g = gen.load(t[side])
                assert isinstance(g.SORTED, bool) and callable(g.keys)


def test_a_missing_name_is_an_error():
    with pytest.raises(KeyError):
        cells.load("no_such.cell")
    with pytest.raises(FileNotFoundError):
        cells.metric_module("no_such_metric")


@pytest.mark.parametrize("name", JOIN_STEP_CELLS)
def test_a_join_step_cell_has_its_configuration_files_sizes(name):
    cell = cells.load(name)
    assert (cell.settings["r_size"], cell.settings["s_size"]) == (
        cell.config["r_size"], cell.config["s_size"])


def test_sizes_must_match_the_configuration_file(monkeypatch):
    real = cells.config_file

    def wrong(name):
        body = dict(real(name))
        body["r_size"] += 1
        return body
    monkeypatch.setattr(cells, "config_file", wrong)
    with pytest.raises(ValueError):
        cells.load(JOIN_STEP_CELLS[0])


def test_files_are_named_from_name_characters():
    for path in (ROOT / "joinbench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
