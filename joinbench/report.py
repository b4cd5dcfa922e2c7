"""The result line of a run, and the check's numbers on standard error."""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from . import cells, trace


def metrics(run, entries) -> dict:
    """``{name: {"value", "unit"}}`` of each metric whose reader found
    something to read."""
    out = {}
    for entry in entries:
        value = cells.metric_module(entry["name"]).read(run)
        if value is not None:
            out[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return out


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` prints it."""
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=20)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"
    return done.stdout.strip().splitlines()[0] if done.stdout.strip() else (
        f"not read ({done.stderr.strip()[:200]})")


def correct(run) -> bool:
    return run.failed == 0 and all(run.check[k] <= lim
                                   for k, lim in run.cell.limits.items())


def result(run, traced: bool) -> dict:
    cuda = torch.cuda.is_available()
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": run.cell.chips,
              "memory_peak_bytes": max(j.peak_bytes for j in run.joins)
              + run.table_bytes}
    out = {"correct": correct(run), "attempted": len(run.joins),
           "failed": run.failed,
           "metrics": metrics(run, run.cell.per_layer if traced
                              else run.cell.end_to_end),
           "device": device}
    if traced:
        device["busy_s"] = sum(map(trace.busy_seconds, run.traced))
        device["window_s"] = sum(j.seconds for j in run.traced)
        out["breakdown"] = trace.breakdown(run.traced)
    out["card"] = power_limit() if cuda else "cpu"
    out["window"] = {"joins": len(run.joins),
                     "join_s": sum(j.seconds for j in run.joins),
                     "generate_s": sum(j.generate_s for j in run.joins)}
    out["check"] = {k: {"value": run.check[k], "limit": lim}
                    for k, lim in run.cell.limits.items()}
    return out


def emit(out: dict) -> None:
    """The check's numbers as the last lines of standard error, then the
    line as the last of standard output."""
    print(f"joinbench: card {out['card']}", file=sys.stderr)
    for k, v in out["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
