"""The device trace of a run: ``torch.profiler`` over a handful of the
window's joins, reduced to what the per-layer metrics read.

The run marks each join with the span ``JOIN_SPAN`` and each generation
with ``GENERATE_SPAN`` (``torch.profiler.record_function``).  The trace is
exported as Chrome trace JSON, where host and device events share one
clock; ``reduce`` keeps, for every join span, the device operations
(kernels, copies, fills) inside it and the host events beside them.  A join
ends in ``torch.cuda.synchronize()`` inside its span, so every device
operation it launched lies inside the span.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import tempfile

import torch

JOIN_SPAN = "joinbench.join"
GENERATE_SPAN = "joinbench.generate"
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "cuda_runtime", "cuda_driver",
                       "user_annotation"})
NO_HOST_CALL = "host python (no runtime call)"
TOP = 10


@dataclasses.dataclass
class TracedJoin:
    """One traced join: its span, and the device operations and host
    events inside it, as ``(name, start, end)`` in seconds."""
    start: float
    end: float
    ops: list
    host: list

    @property
    def seconds(self) -> float:
        return self.end - self.start


def profile():
    """A profiler over the host and, where there is one, the card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def span(name: str, on: bool):
    """``record_function(name)`` while tracing, else nothing."""
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


def trace_events(prof) -> list:
    """The Chrome trace events of a finished profiler (written to a
    temporary file, read back, deleted)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _interval(ev) -> tuple:
    start = float(ev["ts"]) * 1e-6
    return ev.get("name", ""), start, start + float(ev.get("dur", 0)) * 1e-6


def reduce(events: list) -> list:
    """The traced joins, in order, from Chrome trace events."""
    spans, ops, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "ts" not in ev:
            continue
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append(_interval(ev))
        elif cat == "user_annotation" and ev.get("name") == JOIN_SPAN:
            spans.append(_interval(ev)[1:])
        elif cat in HOST_CATS:
            host.append(_interval(ev))
    joins = []
    for lo, hi in sorted(spans):
        inside = [(n, max(a, lo), min(b, hi)) for n, a, b in ops
                  if b > lo and a < hi]
        beside = [(n, a, b) for n, a, b in host if b > lo and a < hi]
        joins.append(TracedJoin(lo, hi, sorted(inside, key=lambda o: o[1]),
                                beside))
    return joins


def union(intervals) -> list:
    """The union of ``(start, end)`` intervals, as disjoint sorted ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def busy_seconds(join: TracedJoin) -> float:
    """Seconds of the join's span in which some device operation ran."""
    return sum(b - a for a, b in union((a, b) for _, a, b in join.ops))


def idle_gaps(join: TracedJoin) -> list:
    """``(start, end)`` of each stretch of the span with no device
    operation running."""
    gaps, t = [], join.start
    for a, b in union((a, b) for _, a, b in join.ops):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if join.end > t:
        gaps.append((t, join.end))
    return gaps


def host_activity(join: TracedJoin, t: float) -> str:
    """What the host was doing at ``t``: the innermost host event (a torch
    op, a runtime call, a span other than the join's) that covers it."""
    best = None
    for name, a, b in join.host:
        if a <= t <= b and name != JOIN_SPAN:
            if best is None or b - a < best[2] - best[1]:
                best = (name, a, b)
    return best[0] if best else NO_HOST_CALL


def short_name(name: str) -> str:
    """A device operation's name without ``void``, the anonymous namespace
    or a kernel's parameter list (the profiler gives some kernels one)."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if (c == "(" and depth == 0 and i
                and (name[i - 1].isalnum() or name[i - 1] in "_>")):
            name = name[:i]
            break
    return name.strip()[:160]


def base_name(name: str) -> str:
    """A kernel's function name: no namespace, template arguments or
    parameters (``radix_scatter`` of ``void ns::radix_scatter<false>(...)``)."""
    head = re.split(r"[<(]", short_name(name), maxsplit=1)[0]
    return head.split("::")[-1].strip()


def device_seconds(joins, pick) -> float:
    """Seconds of the device operations whose name ``pick`` accepts, over
    the traced joins."""
    return sum(b - a for j in joins for n, a, b in j.ops if pick(n))


def breakdown(joins) -> dict:
    """The device operations that took most time (by name, summed over the
    traced joins) and the idle time of the joins' spans by what the host
    was doing, each the ``TOP`` largest, in seconds."""
    ops, gaps = {}, {}
    for j in joins:
        for n, a, b in j.ops:
            key = short_name(n)
            ops[key] = ops.get(key, 0.0) + (b - a)
        for a, b in idle_gaps(j):
            key = host_activity(j, (a + b) / 2)
            gaps[key] = gaps.get(key, 0.0) + (b - a)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}
