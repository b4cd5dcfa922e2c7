"""Cells of ``BENCHMARK.json``, and everything a cell names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  ``configs/<config>.json`` holds the deployment: the CLI arguments
that set its algorithm and sizes (``argv``), the sizes they give
(``r_size``, ``s_size``), its source, ``assumed`` and ``reduced``.
``traffic/<mix>.json`` holds the mix: more CLI arguments (the distribution
as the port's planner is told it) and the generator of each side
(``gen/<name>.py``).  A metric is ``metrics/<metric>.py``.  The join's
``JoinConfig`` is the port CLI's own parse of the two ``argv`` lists.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

from htm_hashjoin_tpu_torch.cli import parse_args

from . import gen

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def config_file(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic_file(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def metric_module(name: str):
    """``metrics/<name>.py``, loaded from its path (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        "joinbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    cfg: object              # the port's JoinConfig
    r_gen: object            # generator modules (``gen``)
    s_gen: object
    end_to_end: list         # the metric entries of BENCHMARK.json
    per_layer: list

    @property
    def r_size(self) -> int:
        return self.cfg.r_size

    @property
    def s_size(self) -> int:
        return self.cfg.s_size


def load(name: str, extra_argv=()) -> Cell:
    """The cell ``name``.  ``extra_argv`` goes after the cell's own
    arguments (the tests shrink the sizes with it); without it the parsed
    sizes must be the configuration file's."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    config = config_file(entry["config"])
    traffic = traffic_file(entry["traffic"])
    cfg, _ = parse_args([*config["argv"], *traffic["argv"], *extra_argv])
    if not extra_argv and (cfg.r_size, cfg.s_size) != (config["r_size"],
                                                       config["s_size"]):
        raise ValueError(f"{entry['config']}: argv gives |R| {cfg.r_size}, "
                         f"|S| {cfg.s_size}; the file says "
                         f"{config['r_size']}, {config['s_size']}")
    return Cell(name=name, chips=entry["chips"], config=config,
                traffic=traffic, cfg=cfg, r_gen=gen.load(traffic["r"]),
                s_gen=gen.load(traffic["s"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])
