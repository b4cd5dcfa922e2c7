"""CLI: ``python -m htm_hashjoin_tpu_torch.harness <grid>|all [options]``,
the experiments/*.sh + runner.sh equivalent, on the card."""

import argparse
import sys

from ..utils.profiler import PerfCounters, disable_counters, enable_counters
from .grids import GRIDS
from .runner import LOG_DIR, run_all, run_grid


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("grid", choices=sorted(GRIDS) + ["all"],
                   help="experiment grid to run ('all' = runner.sh)")
    p.add_argument("--scale", type=int, default=20,
                   help="log2 rSize (reference scale: 27)")
    p.add_argument("--reps", type=int, default=5,
                   help="repetitions per grid (runner.sh N=5)")
    p.add_argument("--outDir", default=None,
                   help="write <grid>_log<i> files here ('all' writes to "
                        f"{LOG_DIR} without it)")
    p.add_argument("--pipelineDepth", type=int, default=1,
                   help="sustained-throughput timing: enqueue K back-to-back "
                        "joins per point, fence once (the single-run time is "
                        "reported alongside)")
    p.add_argument("--counters", nargs="?", const="default", default=None,
                   metavar="CFG",
                   help="per-phase PCM-analog counter dumps in every grid "
                        "JSON line (pcm.cfg analog; see cli --counters)")
    a = p.parse_args(argv)
    if a.counters:
        enable_counters(None if a.counters == "default"
                        else PerfCounters.from_config(a.counters))
    try:
        if a.grid == "all":
            run_all(scale=a.scale, reps=a.reps,
                    out_dir=a.outDir or LOG_DIR,
                    pipeline_depth=a.pipelineDepth, device=device)
        else:
            run_grid(a.grid, scale=a.scale, reps=a.reps, out_dir=a.outDir,
                     pipeline_depth=a.pipelineDepth, device=device)
    finally:
        if a.counters:
            disable_counters()
    return 0


if __name__ == "__main__":
    sys.exit(main())
