"""The host stretches of the two host-bound cells as spans, on the CPU at
their configurations' ``small_argv``: the Wisconsin multijoin's probe
(``wisconsin_independent_2e24x2e28.fk_uniform``), whose host work around
its launches is ``hj.schedule`` (``wisconsin.joiners.HashJoiner``), and
the multipass radix partition (``prj_2e24x2e28.fk_uniform``), whose
planning between K2 and K6 is ``hj.passplan``
(``ops.radix_kernels.multipass_radix_partition``); in both, the host work
that sat bare under ``hj.join`` is ``hj.plan``.  The probe runs its torch
route and, with the device gate opened (``joiners._on_card``), its
kernel's plain version.  Each block's launch stays directly under
``hj.probe``, and each K2 and K6 directly under ``hj.partition``; the
lines' ``readbacks`` are what they were before the spans."""

import json

import pytest
import torch

from joinbench import cells
from htm_hashjoin_tpu_torch.ops import radix_kernels
from htm_hashjoin_tpu_torch.utils import profiler
from htm_hashjoin_tpu_torch.wisconsin import joiners

CPU = torch.device("cpu")
SEED = 2**31 + 29
WISCONSIN = "wisconsin_independent_2e24x2e28.fk_uniform"
PRJ = "prj_2e24x2e28.fk_uniform"
# the waits of one join at small_argv on the CPU: the multijoin's two
# stable splits (two each), its build (key statistics, the permutation
# certificate, the fence), its probe (the heads, the fence) and its line;
# the multipass join's partition fence, build fence, probe count and sums
READBACKS = {WISCONSIN: 10, PRJ: 4}
# the spans directly under hj.join and under each phase, in order
JOIN_CHILDREN = {
    WISCONSIN: ["hj.plan", "hj.split", "hj.split", "hj.build", "hj.probe",
                "hj.line"],
    PRJ: ["hj.plan", "hj.plan", "hj.partition", "hj.build", "hj.probe",
          "hj.line"],
}
# the schedule, the kernel route's gate (and, on the card, its uploads),
# the torch route's pad planning, the heads' readback, the measured
# schedule, the per-partition costs and the probe's fence
PROBE_CHILDREN = {
    "torch": ["hj.schedule", "hj.schedule", "hj.schedule", "hj.readback",
              "hj.schedule", "hj.schedule", "hj.readback"],
    "kernel": ["hj.schedule", "hj.schedule", "hj.readback", "hj.schedule",
               "hj.schedule", "hj.readback"],
}
# two passes: each pass's plan between K2 and K6, and the second pass's
# parents after the first K6; then the partition's fence
PARTITION_CHILDREN = ["hj.passplan", "hj.passplan", "hj.passplan",
                      "hj.readback"]


class CountingRecordFunction:
    entered = 0

    def __init__(self, name, args=None):
        self.name = name

    def __enter__(self):
        CountingRecordFunction.entered += 1
        return self

    def __exit__(self, *exc):
        return False


def inputs(name):
    c = cells.load(name, cells.config_file(name.split(".")[0])["small_argv"])
    return c, c.entry.make(c, c.entry.prepare(c, SEED, CPU), 0, CPU)


def marked(monkeypatch, module, attr, label):
    """``module.attr`` called inside a record function named ``label``."""
    real = getattr(module, attr)

    def call(*args, **kwargs):
        with torch.profiler.record_function(label):
            return real(*args, **kwargs)
    monkeypatch.setattr(module, attr, call)


def profiled(name, tmp_path):
    """(line, events) of one profiled join of the cell ``name``."""
    c, pair = inputs(name)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        line = c.entry.join(c, pair)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "ts" in e]
    return line, sorted(events, key=lambda e: (e["ts"], -e["dur"]))


def inside(ev, outer, eps=0.01):
    return (ev is not outer and ev["ts"] >= outer["ts"] - eps
            and ev["ts"] + ev["dur"] <= outer["ts"] + outer["dur"] + eps)


def innermost(ev, spans):
    """The shortest ``hj.*`` span around ``ev``."""
    around = [s for s in spans if inside(ev, s)]
    return min(around, key=lambda s: s["dur"]) if around else None


def children(outer, spans):
    """The names of the spans directly under ``outer``, in order."""
    return [s["name"] for s in spans if innermost(s, spans) is outer]


def test_the_new_spans_without_a_profiler_are_the_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert {"hj.schedule", "hj.passplan"} <= set(profiler.SPANS)
    for name in ("hj.schedule", "hj.passplan"):
        assert profiler.span(name) is profiler.span("hj.plan")
        with profiler.span(name) as entered:
            assert entered is None


@pytest.mark.parametrize("name,route", [(WISCONSIN, "torch"),
                                        (WISCONSIN, "kernel"),
                                        (PRJ, None)])
def test_no_profiler_no_record_function(name, route, monkeypatch):
    if route == "kernel":
        monkeypatch.setattr(joiners, "_on_card", lambda keys: True)
    c, pair = inputs(name)
    monkeypatch.setattr(torch.profiler, "record_function",
                        CountingRecordFunction)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        CountingRecordFunction)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        CountingRecordFunction, raising=False)
    CountingRecordFunction.entered = 0
    line = c.entry.join(c, pair)
    assert CountingRecordFunction.entered == 0
    assert line["readbacks"] == READBACKS[name]


@pytest.mark.parametrize("route", ["torch", "kernel"])
def test_the_multijoin_probe_opens_hj_schedule_and_hj_plan(route, tmp_path,
                                                           monkeypatch):
    """hj.plan (the factories, the joiner's init) opens inside hj.join
    before the first hj.split; inside hj.probe the schedule's host work
    is hj.schedule, and on the kernel route each block's launch lies
    directly under hj.probe, none under hj.schedule."""
    if route == "kernel":
        monkeypatch.setattr(joiners, "_on_card", lambda keys: True)
    marked(monkeypatch, joiners, "multijoin_probe", "block")
    line, events = profiled(WISCONSIN, tmp_path)
    spans = [e for e in events if e["name"].startswith("hj.")]
    assert {e["name"] for e in spans} <= set(profiler.SPANS)
    (join,) = [e for e in spans if e["name"] == "hj.join"]
    assert children(join, spans) == JOIN_CHILDREN[WISCONSIN]
    plan, split = ([e for e in spans if e["name"] == n][0]
                   for n in ("hj.plan", "hj.split"))
    assert inside(plan, join) and plan["ts"] + plan["dur"] <= split["ts"]
    (probe,) = [e for e in spans if e["name"] == "hj.probe"]
    assert children(probe, spans) == PROBE_CHILDREN[route]
    blocks = [e for e in events if e["name"] == "block"]
    assert len(blocks) == (8 if route == "kernel" else 0)
    assert line["probeKernelBlocks"] == len(blocks)
    assert all(innermost(b, spans) is probe for b in blocks)
    readbacks = [e for e in spans if e["name"] == "hj.readback"]
    assert len(readbacks) == line["readbacks"] == READBACKS[WISCONSIN]


def test_the_multipass_partition_opens_three_hj_passplan(tmp_path,
                                                         monkeypatch):
    """Two passes: three hj.passplan spans inside hj.partition, both K2
    and both K6 launches directly under hj.partition, and hj.plan (the
    tile and the digits' width) inside hj.join before it."""
    marked(monkeypatch, radix_kernels, "sort_tiles", "k2")
    marked(monkeypatch, radix_kernels, "scatter_tiles", "k6")
    line, events = profiled(PRJ, tmp_path)
    spans = [e for e in events if e["name"].startswith("hj.")]
    assert {e["name"] for e in spans} <= set(profiler.SPANS)
    (join,) = [e for e in spans if e["name"] == "hj.join"]
    assert children(join, spans) == JOIN_CHILDREN[PRJ]
    (partition,) = [e for e in spans if e["name"] == "hj.partition"]
    assert children(partition, spans) == PARTITION_CHILDREN
    passplans = [e for e in spans if e["name"] == "hj.passplan"]
    assert all(innermost(e, spans) is partition for e in passplans)
    launches = [e for e in events if e["name"] in ("k2", "k6")]
    assert [e["name"] for e in launches] == ["k2", "k6", "k2", "k6"]
    assert all(innermost(e, spans) is partition for e in launches)
    readbacks = [e for e in spans if e["name"] == "hj.readback"]
    assert len(readbacks) == line["readbacks"] == READBACKS[PRJ]
    assert line["passBits"] == [7, 7] and line["totalOverflows"] == 0
