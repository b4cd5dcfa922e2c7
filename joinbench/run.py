"""Run one cell of the join benchmark on the card.

    python3 joinbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``htm_hashjoin_tpu_torch``).
Prints the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``) as one JSON line, the last of standard output;
the numbers the check compared, each beside its limit, are the last lines
of standard error.  Exits non-zero, printing no result, without enough
CUDA devices, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "htm_hashjoin_tpu"})


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name, whole, is
    forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from joinbench import cells, loop, report

    # one process with one host thread for torch's own CPU work: the join's
    # host path is Python, and idle worker threads only add jitter
    torch.set_num_threads(1)

    cell = cells.load(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"joinbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {found}", file=sys.stderr)
        return 2
    run = loop.run(cell, args.seed, args.seconds, args.trace == 1, "cuda",
                   T0)
    out = report.result(run, args.trace == 1)
    # after the metric readers, which are loaded here, and before the line
    loaded = forbidden_modules()
    if loaded:
        print(f"joinbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    report.emit(out)
    return 0


if __name__ == "__main__":
    # the checkout's root, in place of this file's directory, whose module
    # names (trace, gen) would shadow others
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    sys.exit(main())
