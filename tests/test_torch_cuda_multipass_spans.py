"""The multipass radix join's spans and waits on the card: one traced join
of the benchmark's radix-partition cell (``prj_2e24x2e28.fk_uniform``:
``--algo PRO --radixStrategy multipass --radixBits 14 --radixPasses 2``)
cut to 2^22 ⋈ 2^26.  Each device operation is placed by the runtime call
that issued it (tied by its correlation id, on the host's clock), not by
its own timestamp: every device operation of the join lies inside
``hj.partition``, ``hj.build``, ``hj.probe`` or ``hj.line``; both passes'
K6 (``scatter_tiles_kernel``) run inside ``hj.partition``, K3 and K4
inside ``hj.probe``; every device-to-host copy and every synchronize lies
inside an ``hj.readback`` span; the line's ``readbacks`` is the count of
those waits, and it carries ``partitionedKeys`` and ``totalOverflows``.
The passes' planning ops are issued inside ``hj.passplan``, K2 and K6
directly inside ``hj.partition``; nothing directly inside ``hj.join``.

Needs a CUDA device and nvcc; elsewhere every test skips.  The file
imports no jax:

    python -m pytest tests/test_torch_cuda_multipass_spans.py --noconftest -m gpu -q
"""

import json

import pytest
import torch

from joinbench import cells
from htm_hashjoin_tpu_torch.ops import scatter_tiles

pytestmark = pytest.mark.gpu

NAME = "prj_2e24x2e28.fk_uniform"
ARGV = ["-r", str(1 << 22), "-s", str(1 << 26)]
SEED = 2**31 + 17
# runtime calls that wait for the device
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
         "cudaEventSynchronize")
PHASES = ("hj.partition", "hj.build", "hj.probe", "hj.line")
# the partition's fence, the build's fence, the probe's count and the
# line's key sums
READBACKS = 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def within(t, ev):
    return ev["ts"] <= t <= ev["ts"] + ev["dur"]


def covers(outer, ev):
    return within(ev["ts"], outer) and within(ev["ts"] + ev.get("dur", 0),
                                              outer)


def traced_join(dev, tmp_path):
    """One traced join of the cell after a warm-up: its line, the trace's
    complete events, its ``hj.join`` event, the runtime calls inside it by
    correlation id and the device operations they issued.  K6 runs once a
    pass."""
    cell = cells.load(NAME, ARGV)
    entry = cell.entry
    state = entry.prepare(cell, SEED, dev)
    entry.join(cell, entry.make(cell, state, 2, dev))   # builds, warms up
    inputs = entry.make(cell, state, 0, dev)
    torch.cuda.synchronize(dev)
    before = scatter_tiles.LAUNCHES
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        line = entry.join(cell, inputs)
        torch.cuda.synchronize(dev)
    assert scatter_tiles.LAUNCHES == before + 2       # K6 a pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "ts" in e]
    (join,) = [e for e in events if e["name"] == "hj.join"]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") == "cuda_runtime"
             and "correlation" in e.get("args", {}) and within(e["ts"], join)}
    ops = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and e.get("args", {}).get("correlation") in calls]
    assert ops
    return line, events, join, calls, ops


def test_the_multipass_waits_and_device_work_lie_in_their_spans(dev,
                                                               tmp_path):
    line, events, join, calls, ops = traced_join(dev, tmp_path)
    spans = {name: [e for e in events if e["name"] == name
                    and covers(join, e)]
             for name in (*PHASES, "hj.readback")}
    assert [len(spans[n]) for n in PHASES] == [1, 1, 1, 1]

    def phase(op):
        call = calls[op["args"]["correlation"]]
        return [n for n in PHASES if any(covers(s, call) for s in spans[n])]
    assert all(len(phase(op)) == 1 for op in ops), [
        (op["name"], phase(op)) for op in ops if len(phase(op)) != 1]
    for name, where, least in (("scatter_tiles_kernel", "hj.partition", 2),
                               ("radix_scatter<false>", "hj.probe", 1),
                               ("banded_count_kernel", "hj.probe", 1)):
        launched = [op for op in ops if name in op["name"]]
        assert len(launched) >= least, name
        assert all(phase(op) == [where] for op in launched), name
    sorts = [phase(op)[0] for op in ops if "sort_tiles_kernel" in op["name"]]
    assert sorts.count("hj.partition") == 2 and sorts.count("hj.build") == 1

    copies = [op for op in ops if op["name"].startswith("Memcpy DtoH")]
    for op in copies:
        call = calls[op["args"]["correlation"]]
        assert any(covers(b, call) for b in spans["hj.readback"]), op
    waits = [e for e in calls.values() if e["name"] in WAITS]
    for w in waits:
        assert any(covers(b, w) for b in spans["hj.readback"]), w
    syncs = [w for w in waits if w["name"] == "cudaDeviceSynchronize"]
    assert len(copies) + len(syncs) == len(spans["hj.readback"]) \
        == line["readbacks"] == READBACKS
    assert line["backend"] == "pallas_multipass_radix"
    assert line["passShifts"] == [16, 9] and line["passBits"] == [7, 7]
    assert line["totalOverflows"] == 0 and line["partitionedKeys"] > 0
    assert line["totalMatches"] == 1 << 26


# the kernels a pass launches from K2's and K6's library calls
PASS_KERNELS = ("sort_tiles_kernel", "prefill_kernel", "scatter_tiles_kernel")


def test_the_partitions_planning_lies_in_hj_passplan(dev, tmp_path):
    """Three ``hj.passplan`` spans inside ``hj.partition`` (two passes):
    every device operation the partition issues after its first K2, but
    K2's and K6's own, is issued inside one of them, and none of theirs;
    K2 and K6 (its MAXI32 prefill too) are issued directly inside
    ``hj.partition``; and no device operation is issued directly inside
    ``hj.join``."""
    line, events, join, calls, ops = traced_join(dev, tmp_path)
    spans = [e for e in events
             if e["name"].startswith("hj.") and covers(join, e)]
    (partition,) = [e for e in spans if e["name"] == "hj.partition"]
    plans = [e for e in spans if e["name"] == "hj.passplan"]
    assert len(plans) == 3 and all(covers(partition, e) for e in plans)

    def call(op):
        return calls[op["args"]["correlation"]]

    def where(op):
        return min((s for s in spans if covers(s, call(op))),
                   key=lambda s: s["dur"])

    def launched_by_pass(op):
        return any(k in op["name"] for k in PASS_KERNELS)

    issued = [op for op in ops if covers(partition, call(op))]
    passes = [op for op in issued if launched_by_pass(op)]
    names = [op["name"] for op in passes]
    for kernel in ("sort_tiles_kernel", "scatter_tiles_kernel"):
        assert sum(kernel in name for name in names) == 2, names
    assert all(where(op) is partition for op in passes), [
        (op["name"], where(op)["name"]) for op in passes]
    first_k2 = min(call(op)["ts"] for op in passes
                   if "sort_tiles_kernel" in op["name"])
    planning = [op for op in issued
                if call(op)["ts"] > first_k2 and not launched_by_pass(op)]
    assert planning
    assert all(where(op)["name"] == "hj.passplan" for op in planning), [
        (op["name"], where(op)["name"]) for op in planning
        if where(op)["name"] != "hj.passplan"]
    assert not any(launched_by_pass(op) for op in ops
                   if where(op)["name"] == "hj.passplan")
    assert [op["name"] for op in ops if where(op) is join] == []
