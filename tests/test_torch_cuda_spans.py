"""The port's spans on the card: the ``hj.*`` spans share the clock of the
card's activity, every device-to-host copy of a join lies inside an
``hj.readback`` span, every host wait on the device inside a join goes
through the helper (``utils.timing``), and the line's ``readbacks`` is the
count of those waits.  On the paths of the benchmark's four cells at sizes
a test run holds (``joinbench`` makes the relations), and on the mass path
and the batched repair (S piled on R's first six tiles, of 16 and of 128).
On the hash cell's path (the atomic table), every device operation of the
join lies inside ``hj.build`` or ``hj.probe``, which the benchmark's two
hash-table rooflines read.

Needs a CUDA device and nvcc; elsewhere every test skips.  The file
imports no jax:

    python -m pytest tests/test_torch_cuda_spans.py --noconftest -m gpu -q
"""

import json

import pytest
import torch

from joinbench import cells, loop
from htm_hashjoin_tpu_torch.joins import DISPATCH
from htm_hashjoin_tpu_torch.joins.banded_backend import DEFAULT_TILE
from htm_hashjoin_tpu_torch.relation import Relation

pytestmark = pytest.mark.gpu

SEED = 2**31 + 11
SLACK_US = 50
# runtime calls that wait for the device
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
         "cudaEventSynchronize")
# (cell, its sizes, readbacks, R's tiles S is piled on): fk_zipf1 at this
# size may or may not take the mass path, so its count is held to the
# trace alone
CASES = {
    "fk_uniform": ("pro_2e24x2e28.fk_uniform",
                   ["-r", str(1 << 22), "-s", str(1 << 26)], 1, None),
    "shuffle": ("adaptive_2e27.shuffle", ["--rSize", str(1 << 24)], 3,
                None),
    "fk_zipf1": ("pro_2e24x2e28.fk_zipf1",
                 ["-r", str(1 << 22), "-s", str(1 << 26)], None, None),
    "mass": ("pro_2e24x2e28.fk_zipf1",
             ["-r", str(1 << 17), "-s", str(1 << 20)], 2, 6),
    "repair": ("pro_2e24x2e28.fk_zipf1",
               ["-r", str(1 << 20), "-s", str(1 << 23)], 2, 6),
}
# the hash cell's path, the atomic table (its own test, below)
HASH = ("hashjoin_2e27.shuffle", ["--rSize", str(1 << 20)], 4, None)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def pair(name, index, dev):
    cell_name, argv, _, piled = HASH if name == "hash" else CASES[name]
    cell = cells.load(cell_name, argv)
    r, s = loop.Inputs(cell, SEED, dev).pair(index)
    if piled:
        g = torch.Generator(device=dev).manual_seed(SEED + index)
        s = Relation(torch.randint(1, piled * DEFAULT_TILE + 1,
                                   (cell.s_size,),
                                   generator=g, device=dev,
                                   dtype=torch.int32))
    torch.cuda.synchronize(dev)
    return DISPATCH[cell.cfg.algo.value], r, s, cell.cfg


def within(t, ev, slack=0.0):
    return ev["ts"] - slack <= t <= ev["ts"] + ev["dur"] + slack


def covers(outer, ev, slack=0.0):
    return (within(ev["ts"], outer, slack)
            and within(ev["ts"] + ev.get("dur", 0), outer, slack))


@pytest.mark.parametrize("name", list(CASES))
def test_readbacks_on_the_card_are_the_copies_and_waits(dev, name,
                                                        tmp_path):
    fn, r, s, cfg = pair(name, 2, dev)
    fn(r, s, cfg)                       # builds the kernels, warms up
    del r, s
    joins = [pair(name, i, dev) for i in range(2)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        lines = []
        for fn, r, s, cfg in joins:
            lines.append(fn(r, s, cfg).to_dict())
            torch.cuda.synchronize(dev)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "ts" in e]
    spans = [e for e in events if e["name"].startswith("hj.")]
    outer = sorted((e for e in spans if e["name"] == "hj.join"),
                   key=lambda e: e["ts"])
    assert len(outer) == len(lines)
    readbacks = [e for e in spans if e["name"] == "hj.readback"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and e["name"].startswith("Memcpy DtoH")]
    waits = [e for e in events if e.get("cat") == "cuda_runtime"
             and e["name"] in WAITS]
    assert copies and waits
    for j, line in zip(outer, lines):
        mine = [e for e in readbacks if covers(j, e)]
        my_copies = [c for c in copies if within(c["ts"], j)]
        for c in my_copies:     # on the device's clock, inside the wait
            assert sum(covers(b, c, SLACK_US) for b in mine) == 1, c
        for w in (w for w in waits if within(w["ts"], j)):
            assert any(covers(b, w) for b in mine), w
        syncs = [w for w in waits if w["name"] == "cudaDeviceSynchronize"
                 and any(covers(b, w) for b in mine)]
        assert len(my_copies) + len(syncs) == len(mine) == line["readbacks"]
        want = CASES[name][2]
        assert want is None or line["readbacks"] == want
        if CASES[name][3]:
            assert line["conflictCount"] == CASES[name][3]


def test_the_hash_tables_device_work_lies_in_its_build_and_probe(dev,
                                                                 tmp_path):
    """The atomic table (the hash cell's path): every device operation of
    the join in ``hj.build`` or ``hj.probe``, and its four waits (the
    build's fence and the spill's readback, the probe's fence and its
    readback) in ``hj.readback`` spans.  Two of those spans lie within a
    copy's slack of each other here, so a copy is held to lie in one at
    least."""
    fn, r, s, cfg = pair("hash", 2, dev)
    fn(r, s, cfg)                       # warms up
    del r, s
    fn, r, s, cfg = pair("hash", 0, dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        line = fn(r, s, cfg).to_dict()
        torch.cuda.synchronize(dev)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "ts" in e]
    (join,) = [e for e in events if e["name"] == "hj.join"]
    (build,) = [e for e in events if e["name"] == "hj.build"]
    (probe,) = [e for e in events if e["name"] == "hj.probe"]
    ops = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and within(e["ts"], join)]
    # on the device's clock, inside the host's spans (with the slack of a
    # copy: a few ops at the seam lie within it of both)
    in_build = [covers(build, e, SLACK_US) for e in ops]
    in_probe = [covers(probe, e, SLACK_US) for e in ops]
    assert any(in_build) and any(in_probe)
    assert all(map(max, in_build, in_probe))
    readbacks = [e for e in events if e["name"] == "hj.readback"]
    copies = [e for e in ops if e["name"].startswith("Memcpy DtoH")]
    waits = [e for e in events if e.get("cat") == "cuda_runtime"
             and e["name"] in WAITS and within(e["ts"], join)]
    syncs = [w for w in waits if w["name"] == "cudaDeviceSynchronize"]
    assert all(any(covers(b, w) for b in readbacks) for w in waits)
    assert all(any(covers(b, c, SLACK_US) for b in readbacks)
               for c in copies)
    assert len(copies) + len(syncs) == len(readbacks) == line["readbacks"]
    assert line["readbacks"] == HASH[2]
    assert line["totalMatches"] == 1 << 20 and line["claimRows"] == 4 << 20
