"""Summaries of the harness's grid logs: per grid its points, how many
conserve the key sum and the range of build times; and the source paper's
motivation comparison, PRO's build time against the adaptive HTM build's
at each locality window.

    python -m htm_hashjoin_tpu_torch.harness.report [LOG_DIR]

reads every ``<grid>_log<rep>`` in LOG_DIR (default: ``run_all``'s
directory) and prints one line per grid, then one line per motivation
window (the medians over the reps) and the windows where the HTM build
beats PRO by 2x or more.

The two sides of the motivation comparison are not the same relations:
PRO partitions a PK relation with a windowed local shuffle
(``pk_lshuffle``) and the builds take ``local_shuffle`` keys of the same
window, paired by window as the reference's motivation.sh pairs them.
"""

from __future__ import annotations

import glob
import json
import os
import re
import statistics
import sys
from typing import Dict, List

from .grids import GRIDS, RUNNER_ORDER
from .runner import LOG_DIR

BUILD = "hashBuildTimeInMicroseconds"


def conserved(line: dict) -> bool:
    """inputSum == outputSum; nocc may lose keys by design (outputSum at
    most inputSum)."""
    if line["algo"] == "nocc":
        return line["outputSum"] <= line["inputSum"]
    return line["outputSum"] == line["inputSum"]


def grid_summary(lines: List[dict]) -> dict:
    """Points, conserving points and the min, median and max build
    time."""
    builds = [d[BUILD] for d in lines]
    return {"points": len(lines), "conserved": sum(map(conserved, lines)),
            "buildMinUs": min(builds),
            "buildMedianUs": statistics.median(builds),
            "buildMaxUs": max(builds)}


def motivation_ratios(reps: List[List[dict]]) -> List[dict]:
    """Per window of the motivation grid, over one or more repetitions of
    its lines: the median PRO build time (``algo`` radix), the median
    adaptive HTM build time (``algo`` htm) and PRO / HTM."""
    scale = reps[0][0]["rSize"].bit_length() - 1
    times: Dict[tuple, list] = {}
    for lines in reps:
        for cfg, d in zip(GRIDS["motivation"](scale), lines):
            times.setdefault((cfg.algo.value, cfg.shuffle_range),
                             []).append(d[BUILD])
    out = []
    for i in range(scale + 1):
        w = 1 << i
        pro = statistics.median(times[("radix", w)])
        htm = statistics.median(times[("htm", w)])
        out.append({"window": w, "proUs": pro, "htmUs": htm,
                    "ratio": pro / htm})
    return out


def motivation_lines(ratios: List[dict]) -> List[str]:
    """One line per window, then the windows where HTM wins by 2x."""
    out = [f"motivation: window 2^{r['window'].bit_length() - 1}: PRO "
           f"{r['proUs']:.1f} us (pk_lshuffle), adaptive HTM build "
           f"{r['htmUs']:.1f} us (local_shuffle), PRO/HTM "
           f"{r['ratio']:.3f}" for r in ratios]
    wins = [r["window"].bit_length() - 1 for r in ratios if r["ratio"] >= 2]
    out.append(f"motivation: HTM beats PRO by 2x or more at "
               f"{len(wins)} of {len(ratios)} windows: "
               f"{', '.join(f'2^{w}' for w in wins) or 'none'} (relations "
               f"paired by window, not the same: PRO on pk_lshuffle, the "
               f"builds on local_shuffle)")
    return out


def read_logs(log_dir: str) -> Dict[str, List[List[dict]]]:
    """grid -> its repetitions' lines, from ``<grid>_log<rep>`` files."""
    out = {}
    for name in RUNNER_ORDER:
        paths = glob.glob(os.path.join(log_dir, f"{name}_log*"))
        paths = sorted((p for p in paths
                        if re.fullmatch(r"\d+", p.rsplit("_log", 1)[1])),
                       key=lambda p: int(p.rsplit("_log", 1)[1]))
        reps = []
        for path in paths:
            with open(path) as f:
                reps.append([json.loads(x) for x in f if x.strip()])
        if reps:
            out[name] = reps
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    log_dir = argv[0] if argv else LOG_DIR
    logs = read_logs(log_dir)
    if not logs:
        raise FileNotFoundError(f"no grid logs in {log_dir}")
    for name, reps in logs.items():
        s = grid_summary([d for lines in reps for d in lines])
        print(f"{name}: {len(reps)} reps, {len(reps[0])} points a rep, "
              f"{s['conserved']} of {s['points']} lines conserve, "
              f"{BUILD} {s['buildMinUs']:.1f}..{s['buildMaxUs']:.1f} "
              f"(median {s['buildMedianUs']:.1f})")
    if "motivation" in logs:
        print("\n".join(motivation_lines(motivation_ratios(
            logs["motivation"]))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
