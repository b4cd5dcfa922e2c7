"""Multijoin driver — mc/wisconsin-src/main.cpp:97-420 as a library call.

Counterpart of ``htm_hashjoin_tpu/wisconsin/driver.py``.  Reference flow
(main.cpp): read libconfig → create schemas → generate or load WriteTables
→ JoinerFactory + 2×PartitionerFactory → pthread workers run compute():
barrier, split build side, split probe side, barrier, joiner->build,
barrier, joiner->probe, barrier — with rdtsc checkpoints per phase
(main.cpp:75-94) and cumulative cycles printed (main.cpp:411-413).

Here: the same phases on one device, each ending in a fence of the CUDA
work behind its outputs (``utils.timing.fence_outputs``), so the per-phase
wall spans measure device work; the 'threads' conf knob becomes the
logical shard count of the partitioner layouts and the scheduled probe.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional, Union

from ..utils.device import entry_device
from ..utils.timing import fence_outputs
from .conf import parse_conf
from .hashfn import hash_factory
from .joiners import BaseJoiner, joiner_factory
from .partitioner import partitioner_factory
from .schema import Schema
from .table import Table, WriteTable


@dataclasses.dataclass
class MultijoinResult:
    output: Table
    timings_ns: Dict[str, int]
    stats: Any
    conf: Dict[str, Any]

    @property
    def output_rows(self) -> int:
        return self.output.num_rows

    def to_json_line(self) -> str:
        """One JSON metrics line, schema mirroring the reference's phase
        printout (main.cpp:385-413: realtime per phase + cumulative); the
        same keys as the JAX package's line."""
        t = self.timings_ns
        line = {
            "subsystem": "multijoin",
            "outputRows": self.output_rows,
            "buildRows": self.stats.build_rows,
            "probeRows": self.stats.probe_rows,
            "generateTimeNs": t.get("generate", 0),
            "splitBuildTimeNs": t.get("split_build", 0),
            "splitProbeTimeNs": t.get("split_probe", 0),
            "buildTimeNs": t.get("build", 0),
            "probeTimeNs": t.get("probe", 0),
            "totalJoinTimeNs": (t.get("split_build", 0) + t.get("split_probe", 0)
                                + t.get("build", 0) + t.get("probe", 0)),
        }
        sched = getattr(self.stats, "probe_schedule", None)
        if sched:
            # the MEASURED per-unit probe schedule (ProbeIsPart owner
            # order vs ProbeSteal cost-balanced chunks, probe.inl:18-52)
            line["probeSchedule"] = {
                "policy": sched["policy"],
                "route": sched.get("route", ""),
                "units": len(sched["units"]),
                "workerMicros": [round(x, 1)
                                 for x in sched["worker_micros"]],
                "imbalance": round(sched["imbalance"], 4),
            }
        return json.dumps(line)


def load_side(side_conf: Dict[str, Any], base_path: str, page_size: int,
              device) -> WriteTable:
    """Build or load one input table on ``device`` (main.cpp:263-289:
    generate when the conf says so, else load 'file' from 'path')."""
    schema = Schema.create(side_conf["schema"])
    wt = WriteTable(schema, page_size, device)
    if side_conf.get("generate", False):
        wt.generate(side_conf["relation-size"], side_conf["alphabet-size"],
                    side_conf.get("zipf-param", 0.0), side_conf.get("seed", 0))
    else:
        wt.load(os.path.join(base_path, side_conf["file"]))
    return wt


def run_multijoin(conf: Union[str, Dict[str, Any]], *,
                  write_output: bool = False,
                  base_path: Optional[str] = None,
                  device=None) -> MultijoinResult:
    """Run one configured join end to end on ``device`` (None: the CUDA
    device, which must exist).  ``conf`` is a parsed dict or a path to a
    libconfig ``.conf`` file (the reference's own files work)."""
    dev = entry_device(device, "the multijoin")
    if isinstance(conf, str):
        conf_dir = os.path.dirname(os.path.abspath(conf))
        conf = parse_conf(conf)
    else:
        conf_dir = "."
    base = base_path or conf.get("path", conf_dir)
    nthreads = int(conf.get("threads", 1))
    timings: Dict[str, int] = {}

    def phase(name):
        class _Span:
            def __enter__(self_):
                self_.t0 = time.perf_counter_ns()

            def __exit__(self_, *exc):
                timings[name] = time.perf_counter_ns() - self_.t0
        return _Span()

    with phase("generate"):
        tbuild = load_side(conf["build"], base,
                           conf["partitioner"]["build"].get("pagesize",
                                                            1 << 20), dev)
        tprobe = load_side(conf["probe"], base,
                           conf["partitioner"]["probe"].get("pagesize",
                                                            1 << 20), dev)
        fence_outputs(tbuild.columns + tprobe.columns)

    # factories (main.cpp:250-255)
    pbuild = partitioner_factory(conf["partitioner"]["build"],
                                 conf["partitioner"]["hash"], nthreads)
    pprobe = partitioner_factory(conf["partitioner"]["probe"],
                                 conf["partitioner"]["hash"], nthreads)
    joiner: BaseJoiner = joiner_factory(conf, hash_factory(conf["hash"]),
                                        build_partitioner=pbuild)

    ja1 = int(conf["build"].get("jattr", 1))
    ja2 = int(conf["probe"].get("jattr", 1))
    sel1 = [int(x) for x in conf["build"].get("select", [])]
    sel2 = [int(x) for x in conf["probe"].get("select", [])]
    joiner.init(tbuild.schema, sel1, ja1, tprobe.schema, sel2, ja2)

    # compute() phases (main.cpp:112-145); columns stay on the device
    with phase("split_build"):
        parts_build = pbuild.split(tbuild)
        fence_outputs(parts_build.table.columns)
        if parts_build.table is not tbuild:
            tbuild.columns = []      # free the pre-split original: at the
            # 256M-row reference scale the duplicate costs 2 GB
    with phase("split_probe"):
        parts_probe = pprobe.split(tprobe)
        fence_outputs(parts_probe.table.columns)
        if parts_probe.table is not tprobe:
            tprobe.columns = []
    with phase("build"):
        joiner.build(parts_build)
        fence_outputs([getattr(joiner, a, None) for a in
                       ("_build_keys_sorted", "_build_perm", "_flat_comp",
                        "_build_payload")])
    with phase("probe"):
        output = joiner.probe(parts_probe)
        fence_outputs(output.columns)

    if write_output and "output" in conf:
        output.save(os.path.join(base, conf["output"]))

    return MultijoinResult(output, timings, joiner.stats, conf)
