"""The multijoin's spans and waits on the card: one traced
``wisconsin.driver.join_tables`` of the benchmark's Wisconsin cell cut to
2^22 ⋈ 2^24, where both sides pass the K7 gate (``KV_MIN_ROWS``).  Each
device operation is placed by the runtime call that issued it (tied by
its correlation id, on the host's clock), not by its own timestamp:
every device operation of the join lies inside ``hj.split``, ``hj.build``,
``hj.probe`` or ``hj.line``; K7 (``radix_scatter<true>``) and the pack and
unpack kernels around it run inside ``hj.split``, and the line's
``kvSplits`` counts both splits; the probe kernel runs inside ``hj.probe``,
once a worker block, and the line's ``probeKernelBlocks`` counts the 8
blocks; every device-to-host copy and every
synchronize lies inside an ``hj.readback`` span; and the line's
``readbacks`` is the count of those waits.  The probe's pinned uploads
are issued inside ``hj.schedule`` and its launches directly inside
``hj.probe``; nothing is issued directly inside ``hj.join``.

Needs a CUDA device and nvcc; elsewhere every test skips.  The file
imports no jax:

    python -m pytest tests/test_torch_cuda_multijoin_spans.py --noconftest -m gpu -q
"""

import json

import pytest
import torch

from joinbench import cells
from htm_hashjoin_tpu_torch.ops import global_sort_kv as gkv

pytestmark = pytest.mark.gpu

NAME = "wisconsin_independent_2e24x2e28.fk_uniform"
ARGV = ["--rSize", str(1 << 22), "--sSize", str(1 << 24)]
SEED = 2**31 + 13
# runtime calls that wait for the device
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
         "cudaEventSynchronize")
PHASES = ("hj.split", "hj.build", "hj.probe", "hj.line")
# each split's key range and sizes and its fence; the build's key
# statistics, its permutation certificate and its fence; the probe's
# heads and its fence; the line's sums
READBACKS = 12


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
    correlation id and the device operations they issued.  K7 splits both
    sides."""
    cell = cells.load(NAME, ARGV)
    entry = cell.entry
    state = entry.prepare(cell, SEED, dev)
    entry.join(cell, entry.make(cell, state, 2, dev))   # builds, warms up
    inputs = entry.make(cell, state, 0, dev)
    torch.cuda.synchronize(dev)
    before = gkv.LAUNCHES
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        line = entry.join(cell, inputs)
        torch.cuda.synchronize(dev)
    assert gkv.LAUNCHES == before + 2          # K7 splits both sides
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


def test_the_multijoin_waits_and_device_work_lie_in_their_spans(dev,
                                                                tmp_path):
    line, events, join, calls, ops = traced_join(dev, tmp_path)
    spans = {name: [e for e in events if e["name"] == name
                    and covers(join, e)]
             for name in (*PHASES, "hj.readback")}
    assert [len(spans[n]) for n in PHASES] == [2, 1, 1, 1]

    def phase(op):
        call = calls[op["args"]["correlation"]]
        return [n for n in PHASES if any(covers(s, call) for s in spans[n])]
    assert all(len(phase(op)) == 1 for op in ops), [
        (op["name"], phase(op)) for op in ops if len(phase(op)) != 1]
    for name in ("radix_scatter<true>", "rot_pack_kernel",
                 "rot_unpack_kernel"):
        launched = [op for op in ops if name in op["name"]]
        assert len(launched) >= 2, name
        assert all(phase(op) == ["hj.split"] for op in launched), name
    assert line["kvSplits"] == 2
    probes = [op for op in ops if "multijoin_probe_kernel" in op["name"]]
    assert len(probes) == 8
    assert all(phase(op) == ["hj.probe"] for op in probes)
    assert line["probeKernelBlocks"] == 8

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
    assert line["outputRows"] == 1 << 24


def test_the_probes_host_work_lies_in_hj_schedule(dev, tmp_path):
    """The probe's two pinned uploads (the blocks' unit bounds, the heads)
    are issued inside ``hj.schedule``; the eight probe launches directly
    inside ``hj.probe``, none inside ``hj.schedule``; and no device
    operation is issued directly inside ``hj.join``."""
    line, events, join, calls, ops = traced_join(dev, tmp_path)
    spans = [e for e in events
             if e["name"].startswith("hj.") and covers(join, e)]
    assert len([e for e in spans if e["name"] == "hj.schedule"]) == 4

    def where(op):
        call = calls[op["args"]["correlation"]]
        return min((s for s in spans if covers(s, call)),
                   key=lambda s: s["dur"])

    (probe,) = [e for e in spans if e["name"] == "hj.probe"]
    uploads = [op for op in ops if op["name"].startswith("Memcpy HtoD")
               and covers(probe, calls[op["args"]["correlation"]])]
    assert len(uploads) == 2
    assert all(where(op)["name"] == "hj.schedule" for op in uploads)
    probes = [op for op in ops if "multijoin_probe_kernel" in op["name"]]
    assert len(probes) == line["probeKernelBlocks"] == 8
    assert all(where(op) is probe for op in probes)
    assert [op["name"] for op in ops if where(op) is join] == []
