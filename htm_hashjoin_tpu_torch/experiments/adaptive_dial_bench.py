"""HTM_ADAPT dial measurement on the card: the adaptive plan against both
fixed plans (counterpart of the JAX package's
``experiments/adaptive_dial_bench.py``; its criterion: "a workload where
the adaptive run measurably beats both fixed plans").

Workload: local_shuffle R with a SMALL true window (``--window``) joined
with sorted S, under a config that declares a LARGE window
(``--declared``): the reference's adaptive.sh situation, where the
binary's tSize does not match the data's locality.  The declared window
is wrong on purpose.  Plans, each through ``joins/htm.htm_join``:

  fixed-declared  the plan for the declared window (beyond the wide band:
                  the sort-first plan, K3 + K5),
  fixed-cheap     the optimistic sorter for ``--cheapWindow``, smaller than
                  the data's window (K1's violations force the bitonic
                  retry, a second K1),
  adaptive        ``adaptive=True`` under the declared window: the sniffed
                  displacement picks the sorter (the prepass and K1).

    python -m htm_hashjoin_tpu_torch.experiments.adaptive_dial_bench

One JSON line per plan and rep (plan, rep, timeUs, engineTimeUs,
resorted, adaptivePlan, and the kernels the rep launched) on stdout and
in ``--out``, then one summary line per plan: the median of the warm reps
(rep 0 includes the kernels' build; a repeated adaptive rep reuses the
dial's plan), and whether adaptive beats both fixed plans, a finding and
not a check.  Every rep must give totalMatches == n and inputSum ==
outputSum, or the script raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from typing import Dict, List

from ..config import Algo, Distribution, JoinConfig
from ..data.generators import build_relations
from ..joins.htm import htm_join
from ..relation import Relation
from ..utils.device import entry_device
from ..utils.timing import fence_outputs
from ..utils.validate import check
from . import RESULTS_DIR, kernel_launches, launches_since

PLANS = ("fixed-declared", "fixed-cheap", "adaptive")


def plan_configs(cfg0: JoinConfig, declared: int,
                 cheap_window: int) -> Dict[str, JoinConfig]:
    """The three plans' configs over the data's own ``cfg0``."""
    return {
        # the declared window lies upward: the exact wide-band/sort path
        "fixed-declared": dataclasses.replace(cfg0, shuffle_range=declared),
        # the declared window lies downward: the optimistic sorter is too
        # small and its violations force the bitonic retry
        "fixed-cheap": dataclasses.replace(cfg0, shuffle_range=cheap_window),
        # adaptive measures the data and ignores the declared window
        "adaptive": dataclasses.replace(cfg0, shuffle_range=declared,
                                        adaptive=True),
    }


def run_plans(r: Relation, s: Relation, configs: Dict[str, JoinConfig],
              reps: int, echo: bool = True) -> List[dict]:
    """Run each plan ``reps`` times on R and S; one record a rep.  Each
    rep ends in the join's own readback."""
    n = r.keys.numel()
    lines = []
    for name, cfg in configs.items():
        for i in range(reps):
            before = kernel_launches()
            t0 = time.perf_counter()
            m = htm_join(r, s, cfg)
            us = (time.perf_counter() - t0) * 1e6
            check(m.totalMatches == n and m.inputSum == m.outputSum,
                   f"{name} rep {i}: matches {m.totalMatches} (want {n}), "
                   f"sums {m.inputSum} / {m.outputSum}")
            rec = {"plan": name, "rep": i, "timeUs": us,
                   "engineTimeUs": m.hashBuildTimeInMicroseconds,
                   "resorted": m.extra.get("resorted"),
                   "adaptivePlan": m.extra.get("adaptivePlan"),
                   "launches": launches_since(before)}
            lines.append(rec)
            if echo:
                print(json.dumps(rec), flush=True)
    return lines


def summary(lines: List[dict]) -> dict:
    """Per plan: the median ``timeUs`` of the warm reps (every rep but
    rep 0, or rep 0 alone), the best rep and the last rep's launches; and
    whether adaptive's median beats both fixed plans'."""
    plans = {}
    for name in PLANS:
        recs = [d for d in lines if d["plan"] == name]
        if not recs:
            continue
        warm = [d["timeUs"] for d in recs[1:]] or [recs[0]["timeUs"]]
        plans[name] = {"warmMedianUs": statistics.median(warm),
                       "bestUs": min(d["timeUs"] for d in recs),
                       "launches": recs[-1]["launches"]}
    med = {k: v["warmMedianUs"] for k, v in plans.items()}
    beats = (len(med) == len(PLANS) and med["adaptive"] < min(
        med["fixed-declared"], med["fixed-cheap"]))
    return {"plans": plans, "adaptiveBeatsBoth": beats}


def measure(log2n: int = 26, window: int = 64, declared: int = 1 << 20,
            cheap_window: int = 4, reps: int = 3, device=None,
            echo: bool = True) -> List[dict]:
    """The experiment at its defaults (the JAX script's): 2^log2n keys a
    side, made on the device, then ``run_plans``."""
    dev = entry_device(device, "adaptive_dial_bench")
    cfg0 = JoinConfig(algo=Algo.HTM, r_size=1 << log2n,
                      data_distr=Distribution.LOCAL_SHUFFLE,
                      shuffle_range=window, enable_probe=True)
    r, s = build_relations(cfg0, dev)
    fence_outputs((r.keys, s.keys))
    return run_plans(r, s, plan_configs(cfg0, declared, cheap_window), reps,
                     echo)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--log2n", type=int, default=26)
    p.add_argument("--window", type=int, default=64,
                   help="the data's TRUE locality window")
    p.add_argument("--declared", type=int, default=1 << 20,
                   help="the window the config (wrongly) declares")
    p.add_argument("--cheapWindow", type=int, default=4,
                   help="the fixed-cheap plan's undersized guess")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                 "adaptive_dial_log"))
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu runs the "
                        "kernels' plain versions)")
    a = p.parse_args(argv)
    lines = measure(a.log2n, a.window, a.declared, a.cheapWindow, a.reps,
                    a.device)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    res = summary(lines)
    for name, d in res["plans"].items():
        print(f"# {name}: warm median {d['warmMedianUs'] / 1e3:.3f} ms, "
              f"best {d['bestUs'] / 1e3:.3f} ms, launches {d['launches']}",
              flush=True)
    print(f"# adaptive beats both fixed plans: {res['adaptiveBeatsBoth']}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
