"""Scaling-efficiency harness (counterpart of
``htm_hashjoin_tpu/parallel/scaling.py``): weak + strong scaling over
meshes with a per-phase timing split (exchange vs local join vs repair).

Unlike the production distributed join (``dist_join.distributed_join``:
one call, one readback), each phase here is its own function whose
outputs ``PhaseTimer.timed`` fences, so the log decomposes wall time into:

  exchange  — bucketize + all_to_all (flat) or the two-stage hierarchical
              exchange, both sides,
  join      — local sorted-merge count + psum,
  repair    — the cooperative residual round (only when a bucket
              overflowed; its cost appears only in runs that repair).

A mesh larger than the ordered device list (the device mapping's, else
every device of the kind) is skipped.  A mesh that repeats a device is
"virtual": its shards run one after another on that device, so on one card
the wall time measures the total work of the sharded algorithm, not
scaling, and ``eff(shared)`` is the column to read.

Usage (the card; eight shards on it through a mapping file):
  echo "8 0 1 2 3 4 5 6 7" > /tmp/map8
  export HTM_DEVICE_MAPPING=/tmp/map8
  python -m htm_hashjoin_tpu_torch.parallel.scaling
"""

from __future__ import annotations

import json
import math

import torch

from ..data.generators import pk_keys, sorted_keys, zipf_keys
from ..utils.device import entry_device
from ..utils.timing import PhaseTimer
from . import collectives as cc
from .dist_join import (R_PAD, S_PAD, _active, _caps, _count_sorted,
                        _exchange, _mesh_axis, _pad_to, _residual_counts,
                        _residual_matches, _trimmed, build_dist_join_fn)
from .mesh import Mesh, _ordered_devices, load_device_mapping, make_mesh, \
    shard_relation

OUT_DIR = "experiments/results_scaling_torch"


def _phase_fns(mesh: Mesh, n_r: int, n_s: int, *,
               capacity_factor: float = 2.0, residual_repair: bool = True):
    """Three phase functions sharing dist_join's exchange/count/repair
    machinery: ``ex(rk, sk, r_len, s_len)`` -> (r, s, overflow_r,
    overflow_s, residual counts), ``jo(r, s)`` -> matches, ``rp(r, s,
    counts)`` -> repaired matches, where r and s are the sides'
    ``Exchanged`` records and ``counts`` the residual counts read back."""
    ndev = mesh.size
    cap_r, cap_s = _caps(ndev, n_r, n_s, capacity_factor)
    res_cap = max(n_r, n_s) // ndev if residual_repair else 0
    axis = _mesh_axis(mesh)
    hier = mesh.shape if mesh.ndim == 2 else None

    def psum0(xs):
        return cc.psum(xs, mesh, axis)[0]

    def ex(rk, sk, r_len, s_len):
        r = _exchange(rk, _active(rk, r_len), mesh, axis, hier, ndev, cap_r,
                      R_PAD, res_cap)
        s = _exchange(sk, _active(sk, s_len), mesh, axis, hier, ndev, cap_s,
                      S_PAD, res_cap)
        return r, s, psum0(r.overflow), psum0(s.overflow), \
            _residual_counts(r, s)

    def jo(r, s):
        return psum0([_count_sorted(a, b, ra, sa) for a, b, ra, sa
                      in zip(r.recv, s.recv, r.ok, s.ok)])

    def rp(r, s, counts):
        return psum0(_residual_matches(
            _trimmed(r, counts[:ndev]), _trimmed(s, counts[ndev:]), r.recv,
            s.recv, r.ok, s.ok, mesh, axis))

    return ex, jo, rp


def _relations(mesh: Mesh, n_r: int, n_s: int, data: str, zipf_theta: float,
               seed: int, dev: torch.device):
    """PK R and sorted (or zipf-FK) S, padded and sharded."""
    ndev = mesh.size
    rk = _pad_to(pk_keys(n_r, seed, dev), ndev, R_PAD)
    if data.startswith("zipf"):
        sk = zipf_keys(n_s, n_r, zipf_theta, seed + 1, dev)
    else:
        sk = sorted_keys(n_s, dev)
    sk = _pad_to(sk, ndev, S_PAD)
    return shard_relation(rk, mesh), shard_relation(sk, mesh)


def scaling_point(mesh_shape, n_r: int, n_s: int, *, data: str = "uniform",
                  zipf_theta: float = 1.1, seed: int = 0,
                  reps: int = 2, skew_handling: bool = False,
                  device=None) -> dict:
    """One scaling measurement: phase-split distributed join on a mesh of
    prod(mesh_shape) shards.  Returns the best-of-reps phase times.

    ``skew_handling`` runs the production skew plan (hot keys never move)
    as ONE call — the per-phase split does not apply, so phase columns read
    0 and the total is the call's time."""
    dev = entry_device(device, "the scaling harness")
    names = ("host", "chip") if len(mesh_shape) == 2 else ("x",)
    mesh = make_mesh(tuple(mesh_shape), names, device=dev)
    ndev = mesh.size
    rk, sk = _relations(mesh, n_r, n_s, data, zipf_theta, seed, dev)
    n_rp, n_sp = ndev * rk[0].numel(), ndev * sk[0].numel()
    base = {"mesh": list(mesh_shape), "ndev": ndev, "nR": n_r, "nS": n_s,
            "data": data}
    best = None
    if skew_handling:
        fn = build_dist_join_fn(mesh, n_rp, n_sp, skew_handling=True)
        for _ in range(max(1, reps)):
            timer = PhaseTimer()
            res = timer.timed("total", fn, rk, sk, n_r, n_s)
            v = dict(zip(res._fields, torch.stack(
                [x.to(res.matches.device) for x in res]).tolist()))
            point = dict(base, exchangeTimeUs=0.0, joinTimeUs=0.0,
                         repairTimeUs=0.0, totalTimeUs=timer.total(),
                         matches=v["matches"], repairFired=False,
                         overflowR=v["dropped_r"] + v["repaired_r"],
                         overflowS=v["dropped_s"] + v["repaired_s"],
                         skewHandling=True, hotKeys=v["num_hot"])
            if best is None or point["totalTimeUs"] < best["totalTimeUs"]:
                best = point
    else:
        ex, jo, rp = _phase_fns(mesh, n_rp, n_sp)
        for _ in range(max(1, reps)):
            timer = PhaseTimer()
            r, s, rov, sov, n_res = timer.timed("exchange", ex, rk, sk, n_r,
                                                n_s)
            counts = n_res.tolist()
            matches = int(timer.timed("join", jo, r, s))
            if sum(counts) > 0:
                matches += int(timer.timed("repair", rp, r, s, counts))
            point = dict(base,
                         exchangeTimeUs=timer.micros.get("exchange", 0.0),
                         joinTimeUs=timer.micros.get("join", 0.0),
                         repairTimeUs=timer.micros.get("repair", 0.0),
                         totalTimeUs=timer.total(), matches=matches,
                         repairFired=sum(counts) > 0, overflowR=int(rov),
                         overflowS=int(sov))
            del r, s
            if best is None or point["totalTimeUs"] < best["totalTimeUs"]:
                best = point
    # PK ⋈ (sorted|zipf-FK): every S tuple matches exactly once
    best["matchesExpected"] = n_s
    best["exact"] = best["matches"] == n_s
    return best


def _available_devices(device) -> list:
    """The ordered device list a mesh draws from: the mapping's, else every
    device of ``device``'s kind."""
    return _ordered_devices(load_device_mapping(),
                            entry_device(device, "the scaling harness"))


def scaling_sweep(out_path: str, *, per_dev_log2: int = 17,
                  strong_log2: int = 20, reps: int = 2,
                  meshes=((1,), (2,), (4,), (8,), (2, 2), (2, 4)),
                  echo: bool = True, device=None) -> list:
    """Weak + strong scaling × flat/hierarchical × uniform/zipf sweep.
    Writes one JSON line per point to out_path (the scaling_log), each with
    its efficiencies against the 1-shard point of the same (mode, data)."""
    dev = entry_device(device, "the scaling harness")
    ndevs_avail = len(_available_devices(dev))
    lines = []
    for mode in ("weak", "strong"):
        for mesh_shape in meshes:
            ndev = math.prod(mesh_shape)
            if ndev > ndevs_avail:
                continue
            n = (1 << per_dev_log2) * ndev if mode == "weak" \
                else (1 << strong_log2)
            for data, skew in (("uniform", False), ("zipf", False),
                               ("zipf+skew", True)):
                pt = scaling_point(mesh_shape, n, n, data=data, reps=reps,
                                   skew_handling=skew, device=dev)
                pt["mode"] = mode
                lines.append(pt)
                if echo:
                    print(json.dumps(pt), flush=True)
    # `efficiency` assumes every shard has a device of its own;
    # `efficiencyShared` normalizes against serialized execution of the
    # same total work on one device — what a virtual mesh (shards sharing
    # a device) can measure
    base = {(p["mode"], p["data"]): p for p in lines if p["ndev"] == 1}
    for p in lines:
        b = base.get((p["mode"], p["data"]))
        if not b or p["ndev"] == 1:
            p["efficiency"] = p["efficiencyShared"] = 1.0
            continue
        if p["mode"] == "weak":       # real ideal: constant time
            p["efficiency"] = b["totalTimeUs"] / p["totalTimeUs"]
            p["efficiencyShared"] = (p["ndev"] * b["totalTimeUs"] /
                                     p["totalTimeUs"])
        else:                         # real ideal: time / ndev
            p["efficiency"] = b["totalTimeUs"] / (p["ndev"] *
                                                  p["totalTimeUs"])
            p["efficiencyShared"] = b["totalTimeUs"] / p["totalTimeUs"]
    with open(out_path, "w") as f:
        for p in lines:
            f.write(json.dumps(p) + "\n")
    return lines


def summary(lines: list, devices: list) -> str:
    """SCALING.md: the sweep's table and how to read it."""
    virt = len(set(devices)) < len(devices)
    kinds = sorted({str(d) for d in devices})
    md = [
        "# Scaling efficiency" + (" (virtual mesh)" if virt else ""), "",
        f"Devices: {len(devices)} in mapping order, on {', '.join(kinds)}"
        + (f" ({torch.cuda.get_device_name(0)})"
           if any(d.type == "cuda" for d in devices) else "") + ".",
        "Weak: n/shard constant (ideal = flat time).  Strong: total n "
        "constant (ideal = 1/ndev time).  Phase split: exchange "
        "(bucketize+all_to_all) / local join / repair.", "",
    ]
    if virt:
        md += [
            "**Virtual mesh**: the mapping repeats a device, so shards run "
            "one after another on it and wall-clock `eff(hw)` measures the "
            "total work of the sharded algorithm, not scaling.  `eff(shared)` "
            "normalizes against serialized execution of the same total work "
            "on one device: near or above 100% means sharding adds no "
            "overhead beyond the work itself.", "",
        ]
    md += [
        "| mode | mesh | data | exchange ms | join ms | repair ms | "
        "total ms | matches exact | eff(hw) | eff(shared) |",
        "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |",
    ]
    for p in lines:
        md.append("| {} | {} | {} | {:.1f} | {:.1f} | {:.1f} | {:.1f} | "
                  "{} | {:.0%} | {:.0%} |".format(
                      p["mode"], "x".join(map(str, p["mesh"])), p["data"],
                      p["exchangeTimeUs"] / 1e3, p["joinTimeUs"] / 1e3,
                      p["repairTimeUs"] / 1e3, p["totalTimeUs"] / 1e3,
                      p["exact"], p["efficiency"], p["efficiencyShared"]))
    md += [
        "",
        "## Reading the rows",
        "",
        "* **uniform / zipf rows** run the phase-split pipeline: one "
        "bucketize (stable sort by destination) + all_to_all exchange "
        "(flat) or the fused hierarchical variant (2x2/2x4: the same "
        "single bucketize + chip-level all_to_all + transpose + host-level "
        "all_to_all), then the local tagged-sort count, then the "
        "cooperative residual repair iff any send bucket overflowed.",
        "* **zipf (skew off) rows** repair where a hot destination's send "
        "bucket overflows (repair ms > 0): the cost of NOT using the skew "
        "plan, kept as the ablation.",
        "* **zipf+skew rows** run the production plan for skewed data "
        "(sampled heavy hitters never move; hot matches come from two "
        "psums of per-key counts) as one call: no phase split, no repair.",
    ]
    return "\n".join(md) + "\n"


def main(argv=None, device=None) -> int:
    import argparse
    import os

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--outDir", default=OUT_DIR)
    p.add_argument("--perDevLog2", type=int, default=17)
    p.add_argument("--strongLog2", type=int, default=20)
    p.add_argument("--reps", type=int, default=2)
    a = p.parse_args(argv)
    dev = entry_device(device, "the scaling harness")
    os.makedirs(a.outDir, exist_ok=True)
    lines = scaling_sweep(os.path.join(a.outDir, "scaling_log"),
                          per_dev_log2=a.perDevLog2,
                          strong_log2=a.strongLog2, reps=a.reps, device=dev)
    md = summary(lines, _available_devices(dev))
    with open(os.path.join(a.outDir, "SCALING.md"), "w") as f:
        f.write(md)
    print(md, end="")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
