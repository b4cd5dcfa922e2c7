"""The control of the check, and the program's readings beside it.

    python3 joinbench/control.py --workload <cell> --seeds 1,2,3 --seconds 2

For each seed, one short window of the program (its worst gap of each
number compared, the limit's lower reading) and one of the control: the
cell's entry's plain reference (its ``expected``) computed with 32-bit
accumulators, the nearest precision below the configuration's 64-bit
sums, put in the program's place (the upper reading).  The control has to come out not correct.  Prints one JSON
line a run; needs the card, as ``run.py`` does.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def control_join(cell, inputs):
    """The entry's reference in 32-bit accumulators, in the program's
    place (``loop.run``'s ``join_fn``)."""
    import torch
    return cell.reference.expected(inputs, accumulator=torch.int32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)

    import torch
    from joinbench import cells, loop, report

    if not torch.cuda.is_available():
        print("joinbench: the control needs a CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    for seed in map(int, args.seeds.split(",")):
        for side, fn in (("program", None), ("control", control_join)):
            run = loop.run(cell, seed, args.seconds, False, "cuda",
                           time.perf_counter(), join_fn=fn)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "side": side, "correct": report.correct(run),
                              "attempted": len(run.joins),
                              "failed": run.failed, "check": run.check}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    sys.exit(main())
