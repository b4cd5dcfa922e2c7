"""Cells of ``BENCHMARK.json``, and everything a cell names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  ``configs/<config>.json`` holds the deployment: its source,
``assumed``, ``reduced``, ``small_argv`` (what the CPU tests hand its
entry's ``load`` to shrink the sizes), ``entry`` (the join step its cells
time, ``join_step`` where the key is absent) and that entry's settings.
``traffic/<mix>.json`` holds the mix, as the entry reads it.  An entry is
``entries/<entry>.py`` with its plain reference beside it,
``entries/<entry>_reference.py``; a metric is ``metrics/<metric>.py``.

An entry module defines ``TRAFFIC_KEYS`` (the keys of its traffic files)
and

* ``load(config, traffic, extra_argv)``: the cell's settings, a dict
  (``cell.settings``);
* ``prepare(cell, seed, device)``: the state made once a run, and
  ``table_bytes(state)``, its device bytes;
* ``make(cell, state, index, device)``: join ``index``'s inputs, from
  ``(seed, index)`` streams (``gen.generator``), made outside the timed
  interval; they report ``tuples`` and ``fingerprint()``;
* ``join(cell, inputs)``: the timed call into the program, returning the
  join's line as a dict.

Its reference module imports nothing of the program and defines
``FIELDS``, the numbers of a join's line that the check holds exactly, and
``expected(inputs, accumulator=torch.int64)``, their values worked out
again from the inputs; with ``torch.int32``, the control.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CONFIGS = HERE / "configs"
TRAFFIC = HERE / "traffic"
ENTRIES = HERE / "entries"
METRICS = HERE / "metrics"
DEFAULT_ENTRY = "join_step"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def config_file(name: str) -> dict:
    return _json(CONFIGS / f"{name}.json")


def traffic_file(name: str) -> dict:
    return _json(TRAFFIC / f"{name}.json")


def _module(kind: str, directory: Path, name: str):
    """``<directory>/<name>.py``, loaded from its path (a name may hold
    dots)."""
    path = directory / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"joinbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod     # where a dataclass looks itself up
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str):
    """``metrics/<name>.py``: the metric's reader."""
    return _module("metric", METRICS, name)


def entry_module(name: str):
    """``entries/<name>.py``: the join step a configuration's cells time."""
    return _module("entry", ENTRIES, name)


def reference_module(name: str):
    """``entries/<name>_reference.py``: the entry's plain reference."""
    return _module("reference", ENTRIES, f"{name}_reference")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    entry: object            # the entry module
    reference: object        # its reference module
    settings: dict           # what the entry's ``load`` gave
    limits: dict             # each number the check compares: its limit
    end_to_end: list         # the metric entries of BENCHMARK.json
    per_layer: list

    def __getattr__(self, key):
        # ``join_step``'s settings as attributes (``cell.cfg``,
        # ``cell.s_size``), for the port's own tests; the harness reads
        # ``cell.settings``
        settings = self.__dict__.get("settings", {})
        if key in settings:
            return settings[key]
        raise AttributeError(f"cell {self.__dict__.get('name')!r} has no "
                             f"{key!r}; its settings: {sorted(settings)}")


def load(name: str, extra_argv=()) -> Cell:
    """The cell ``name``.  ``extra_argv`` goes to its entry's ``load``
    (the tests shrink the sizes with it)."""
    bench = benchmark()
    workload = next((w for w in bench["workloads"] if w["name"] == name),
                    None)
    if workload is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    config = config_file(workload["config"])
    traffic = traffic_file(workload["traffic"])
    entry_name = config.get("entry", DEFAULT_ENTRY)
    entry = entry_module(entry_name)
    reference = reference_module(entry_name)
    return Cell(name=name, chips=workload["chips"], config=config,
                traffic=traffic, entry=entry, reference=reference,
                settings=entry.load(config, traffic, extra_argv),
                # every field of the reference's exact
                limits={f"{field}_gap": 0 for field in reference.FIELDS},
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])
