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
``run_multijoin`` makes the tables and hands them to ``join_tables``, the
timed phases and the line, which a caller that makes its own tables (the
benchmark's ``multijoin`` entry) calls as it is.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional, Union

import torch

from ..utils import timing
from ..utils.device import entry_device
from ..utils.profiler import span
from ..utils.timing import fence_outputs, readback
from .conf import parse_conf
from .hashfn import hash_factory
from . import joiners, partitioner
from .joiners import BaseJoiner, joiner_factory
from .partitioner import partitioner_factory
from .schema import Schema
from .table import Table, WriteTable, is_strings


#: the port's fields of the multijoin's line beside the JAX package's keys:
#: three sums over the output's valid rows, in 64 bits, which depend on
#: which rows were paired (``output_sums``), the host's waits on the
#: device over the join (``utils.timing.READBACKS``), the splits that ran
#: the pack kernel, K7 and the unpack kernel (``partitioner.KV_SPLITS``)
#: and the probe's worker blocks that ran the probe kernel
#: (``joiners.PROBE_KERNEL_BLOCKS``)
PORT_ONLY_FIELDS = frozenset({"outputBuildSum", "outputProbeSum",
                              "outputPairSum", "readbacks", "kvSplits",
                              "probeKernelBlocks"})
_SUM_FIELDS = ("outputBuildSum", "outputProbeSum", "outputPairSum")

#: rows of the output a block of the line's sums takes: its int64 copies
#: of a column are 128 MiB, not the 2 GiB of a 2^28-row output
SUM_BLOCK = 1 << 24


@dataclasses.dataclass
class MultijoinResult:
    output: Table
    timings_ns: Dict[str, int]
    stats: Any
    conf: Dict[str, Any]
    fields: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def output_rows(self) -> int:
        return self.output.num_rows

    def to_dict(self) -> dict:
        """The metrics line, schema mirroring the reference's phase
        printout (main.cpp:385-413: realtime per phase + cumulative): the
        JAX package's keys, then the port's own (``PORT_ONLY_FIELDS``)."""
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
        line.update(self.fields)
        return line

    def to_json_line(self) -> str:
        """``to_dict`` as one JSON line."""
        return json.dumps(self.to_dict())


def page_size(conf: Dict[str, Any], side: str) -> int:
    """Rows a page of one side's input table (the side's partitioner's
    'pagesize'): the unit the independent split deals to its shards."""
    return conf["partitioner"][side].get("pagesize", 1 << 20)


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


def load_tables(conf: Dict[str, Any], base_path: str, device):
    """The build and probe tables on ``device``, generated or loaded
    (``load_side``), their device work fenced."""
    tables = tuple(load_side(conf[side], base_path, page_size(conf, side),
                             device) for side in ("build", "probe"))
    fence_outputs(tables[0].columns + tables[1].columns)
    return tables


def output_sums(output: Table, n_build: int) -> torch.Tensor:
    """``[Σ build-side columns, Σ probe-side columns, Σ first build-side
    column × first probe-side column]`` over the output's valid rows
    (``Table.column``), each value cast to int64, wrapping at 64 bits, as
    one int64 tensor on the output's device.  The output's first
    ``n_build`` columns come from the build side; string columns are left
    out.  Worked out in blocks of ``SUM_BLOCK`` rows."""
    cols = [(i < n_build, output.column(i + 1))
            for i, c in enumerate(output.columns) if not is_strings(c)]
    if not cols:
        return torch.zeros(3, dtype=torch.int64)
    zero = cols[0][1].new_zeros((), dtype=torch.int64)
    blocks = []
    for a in range(0, output.num_rows, SUM_BLOCK):
        build = [c[a:a + SUM_BLOCK].to(torch.int64) for b, c in cols if b]
        probe = [c[a:a + SUM_BLOCK].to(torch.int64) for b, c in cols
                 if not b]
        blocks.append(torch.stack([
            sum((x.sum() for x in build), zero),
            sum((x.sum() for x in probe), zero),
            (build[0] * probe[0]).sum() if build and probe else zero]))
    if not blocks:
        return zero.new_zeros(3)
    return torch.stack(blocks).sum(0)


@contextlib.contextmanager
def _phase(timings: Dict[str, int], name: str):
    """Host nanoseconds of the block into ``timings[name]``."""
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        timings[name] = time.perf_counter_ns() - t0


def join_tables(conf: Dict[str, Any], tbuild: Table,
                tprobe: Table) -> MultijoinResult:
    """One configured join of two tables, on their device: main.cpp's
    compute() phases (:112-145), split build side, split probe side, build,
    probe, each ending in a fence of the device work behind its outputs
    and timed in ``timings_ns``; then the line's own numbers (``fields``):
    the output's sums (``output_sums``), the waits over the call, its
    splits through the packing kernels and K7 and its probe's worker
    blocks through the probe kernel.

    Spans: ``hj.join`` around the call, ``hj.plan`` around the factories
    and the joiner's ``init``, ``hj.split`` around each split,
    ``hj.build`` and ``hj.probe`` around the joiner's two phases,
    ``hj.line`` around the sums.  A split that copies its input frees the
    input's columns (``tbuild.columns`` and ``tprobe.columns`` become
    empty): at the 256M-row reference scale the copy costs 2 GB."""
    reads, kv_splits = timing.READBACKS, partitioner.KV_SPLITS
    probe_blocks = joiners.PROBE_KERNEL_BLOCKS
    timings: Dict[str, int] = {}
    with span("hj.join"):
        with span("hj.plan"):
            # factories (main.cpp:250-255)
            nthreads = int(conf.get("threads", 1))
            pbuild = partitioner_factory(conf["partitioner"]["build"],
                                         conf["partitioner"]["hash"],
                                         nthreads)
            pprobe = partitioner_factory(conf["partitioner"]["probe"],
                                         conf["partitioner"]["hash"],
                                         nthreads)
            joiner: BaseJoiner = joiner_factory(
                conf, hash_factory(conf["hash"]), build_partitioner=pbuild)
            sel1 = [int(x) for x in conf["build"].get("select", [])]
            sel2 = [int(x) for x in conf["probe"].get("select", [])]
            joiner.init(tbuild.schema, sel1,
                        int(conf["build"].get("jattr", 1)), tprobe.schema,
                        sel2, int(conf["probe"].get("jattr", 1)))

        with _phase(timings, "split_build"), span("hj.split"):
            parts_build = pbuild.split(tbuild)
            fence_outputs(parts_build.table.columns)
            if parts_build.table is not tbuild:
                tbuild.columns = []
        with _phase(timings, "split_probe"), span("hj.split"):
            parts_probe = pprobe.split(tprobe)
            fence_outputs(parts_probe.table.columns)
            if parts_probe.table is not tprobe:
                tprobe.columns = []
        with _phase(timings, "build"), span("hj.build"):
            joiner.build(parts_build)
            fence_outputs([getattr(joiner, a, None) for a in
                           ("_build_keys_sorted", "_build_perm",
                            "_flat_comp", "_build_payload")])
        with _phase(timings, "probe"), span("hj.probe"):
            output = joiner.probe(parts_probe)
            fence_outputs(output.columns)

        with span("hj.line"):
            fields = dict(zip(_SUM_FIELDS,
                              readback(output_sums(output, len(sel1)))))
            fields["readbacks"] = timing.READBACKS - reads
            fields["kvSplits"] = partitioner.KV_SPLITS - kv_splits
            fields["probeKernelBlocks"] = (joiners.PROBE_KERNEL_BLOCKS
                                           - probe_blocks)
    return MultijoinResult(output, timings, joiner.stats, conf, fields)


def run_multijoin(conf: Union[str, Dict[str, Any]], *,
                  write_output: bool = False,
                  base_path: Optional[str] = None,
                  device=None) -> MultijoinResult:
    """Run one configured join end to end on ``device`` (None: the CUDA
    device, which must exist): the tables (``load_tables``, timed as
    ``generate``), then ``join_tables``.  ``conf`` is a parsed dict or a
    path to a libconfig ``.conf`` file (the reference's own files work)."""
    dev = entry_device(device, "the multijoin")
    if isinstance(conf, str):
        conf_dir = os.path.dirname(os.path.abspath(conf))
        conf = parse_conf(conf)
    else:
        conf_dir = "."
    base = base_path or conf.get("path", conf_dir)
    timings: Dict[str, int] = {}
    with _phase(timings, "generate"):
        tbuild, tprobe = load_tables(conf, base, dev)
    res = join_tables(conf, tbuild, tprobe)
    res.timings_ns = {**timings, **res.timings_ns}

    if write_output and "output" in conf:
        res.output.save(os.path.join(base, conf["output"]))
    return res
