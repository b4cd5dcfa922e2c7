"""The multipass radix partition against the global sort, over log2 n
(counterpart of the JAX package's ``experiments/radix_crossover.py``).

Both engines give the same class of artifact, a value-ordered relation in
sorted tiles that the banded count probes:

  sort       ``ops/global_sort.global_sort_tiles`` (K3) on the keys padded
             to a power-of-two count of 8192-key tiles,
  multipass  ``ops/radix_kernels.multipass_radix_partition`` (two passes,
             K2 then K6 each), then the final ``sort_tiles`` bitonic (K2).

On the TPU the sort engine was a bitonic network; here K3 is itself a
radix sort, so the crossover the JAX script looked for may not exist.

    python -m htm_hashjoin_tpu_torch.experiments.radix_crossover

One JSON line per (engine, log2 n): engine, log2n, timeUs (the best of
``--reps``, each ending in a synchronise), radixBits, mtuples_per_s; then
the multipass/sort ratio per size.  The keys are ``shuffled_keys(n, 0)``.
Each output must hold the input as a multiset (MAXI32 padding aside); the
sort output must be ascending, and the multipass output ascending within
every tile with its regions (the last pass's digits) in value order; else
the script raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List

import torch

from ..constants import MAXI32
from ..data.generators import shuffled_keys
from ..joins.banded_backend import DEFAULT_TILE, to_tiles_pow2
from ..ops.global_sort import global_sort_tiles
from ..ops.radix_kernels import multipass_radix_partition
from ..ops.sort_tiles import sort_tiles
from ..utils.device import entry_device
from ..utils.timing import fence_outputs
from ..utils.validate import check
from . import RESULTS_DIR

ENGINES = ("sort", "multipass")
SIZES = (20, 22, 24, 26, 27)     # the JAX script's defaults: log2 n,
REPS = 3                         # repetitions (the best is reported)
RADIX_BITS = 14                  # and the multipass partition's bits


def run_engine(engine: str, keys: torch.Tensor, log2n: int,
               radix_bits: int):
    """One engine's artifact of ``keys``: (flat int32 output, the shift of
    the last pass's digit, None for the sort engine)."""
    if engine == "sort":
        return global_sort_tiles(to_tiles_pow2(keys, DEFAULT_TILE),
                                 tile=DEFAULT_TILE), None
    res = multipass_radix_partition(keys, radix_bits=radix_bits, passes=2,
                                    key_bits=max(1, log2n + 1),
                                    tile=DEFAULT_TILE)
    out, _ = sort_tiles(res.partitioned, tile=DEFAULT_TILE, method="bitonic")
    return out, res.pass_plans[-1].shift


def check_output(engine: str, keys: torch.Tensor, out: torch.Tensor,
                 shift) -> None:
    """Raise unless ``out`` holds ``keys`` as a multiset and is in the
    engine's order (see the module docstring)."""
    want = torch.sort(keys).values
    real = out[out != MAXI32]
    check(torch.equal(torch.sort(real).values, want),
           f"{engine}: the output does not hold the input as a multiset")
    if engine == "sort":
        check(torch.equal(out[:keys.numel()], want),
               "sort: the output is not ascending")
        return
    tiles = out.view(-1, DEFAULT_TILE)
    check(bool((tiles[:, 1:] >= tiles[:, :-1]).all()),
           "multipass: a tile is not ascending")
    regions = real >> shift
    check(bool((regions[1:] >= regions[:-1]).all()),
           "multipass: the regions are not in value order")


def crossover(sizes: List[int], reps: int, radix_bits: int, device,
              echo: bool = True) -> List[dict]:
    """Both engines at each log2 n of ``sizes``; one line each."""
    lines = []
    for lg in sizes:
        n = 1 << lg
        keys = shuffled_keys(n, 0, device)
        for engine in ENGINES:
            best = None
            for _ in range(reps):
                fence_outputs(keys)
                t0 = time.perf_counter()
                out, shift = fence_outputs(run_engine(engine, keys, lg,
                                                      radix_bits))
                us = (time.perf_counter() - t0) * 1e6
                best = us if best is None else min(best, us)
            check_output(engine, keys, out, shift)
            del out
            line = {"engine": engine, "log2n": lg, "timeUs": best,
                    "radixBits": radix_bits, "mtuples_per_s": n / best}
            lines.append(line)
            if echo:
                print(json.dumps(line), flush=True)
        del keys
    return lines


def ratios(lines: List[dict]) -> dict:
    """log2 n -> multipass timeUs / sort timeUs, where both ran."""
    by = {}
    for line in lines:
        by.setdefault(line["log2n"], {})[line["engine"]] = line["timeUs"]
    return {lg: d["multipass"] / d["sort"] for lg, d in sorted(by.items())
            if len(d) == len(ENGINES)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                 "radix_crossover_log"))
    p.add_argument("--sizes", default=",".join(map(str, SIZES)))
    p.add_argument("--reps", type=int, default=REPS)
    p.add_argument("--radixBits", type=int, default=RADIX_BITS)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu runs the "
                        "kernels' plain versions)")
    a = p.parse_args(argv)
    dev = entry_device(a.device, "radix_crossover")
    lines = crossover([int(x) for x in a.sizes.split(",")], a.reps,
                      a.radixBits, dev)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    for lg, r in ratios(lines).items():
        print(f"# 2^{lg}: multipass/sort = {r:.2f}x "
              f"({'multipass wins' if r < 1 else 'sort wins'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
