"""Headline benchmark of the port: banded build+probe on locality data.

Same workload, asserts and JSON keys as the JAX package's ``bench.py``: a
2^27-key build side with locality (``local_shuffled_keys(n, 16, 0)``),
probed by a sorted 2^27-key side, full build+probe through the fence-free
pipeline.  The headline is sustained throughput over PIPE back-to-back
joins read back once; the single-run time (one join, one host readback)
is reported beside it.  Runs only on a CUDA device.

Baseline: the reference's HTM build+probe, 456,915 us for 2^27 + 2^27
keys on its CPU machine; ``vs_baseline`` is our throughput over that.

    python -m htm_hashjoin_tpu_torch.bench      # prints ONE JSON line
"""

from __future__ import annotations

import json
import os
import time

import torch

REFERENCE_BUILD_PROBE_US = 456_915.0     # experiments/overflow_log1:1


def measure(log2_n: int = 27, window: int = 16, reps: int = 3,
            pipe: int = 5) -> dict:
    """Run the workload on the current CUDA device and return the JSON
    record (asserting exact matches and conservation on every read)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA device")
    from .data.generators import local_shuffled_keys, sorted_keys
    from .joins.banded_backend import (banded_join_pipelined,
                                       enqueue_banded_join, prepare_probe_side)

    n = 1 << log2_n
    dev = torch.device("cuda")
    rkeys = local_shuffled_keys(n, window, 0, device=dev)
    skeys = sorted_keys(n, device=dev)
    s2d = prepare_probe_side(skeys)
    torch.cuda.synchronize()          # generation stays out of the timings
    expect_sum = n * (n + 1) // 2

    def join():
        return banded_join_pipelined(rkeys, skeys, locality_window=window,
                                     unique_both=True, s2d=s2d)

    out = join()                      # warm-up: builds and loads the kernel
    assert out.matches == n, f"expected {n} matches, got {out.matches}"
    assert out.output_sum == expect_sum, "conservation violated"
    assert out.violations == 0 and out.overflow_tiles == 0

    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = join()                  # ends in its one host readback
        best = min(best, time.perf_counter() - t0)
    assert out.matches == n

    best_pipe = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _j in range(pipe):
            res = enqueue_banded_join(rkeys, skeys, locality_window=window,
                                      unique_both=True, s2d=s2d)
        bundle = torch.stack(res[:5]).tolist()   # ONE readback for the batch
        torch.cuda.synchronize()
        best_pipe = min(best_pipe, (time.perf_counter() - t0) / pipe)
    assert bundle[0] == n and bundle[1] == 0 and bundle[2] == 0
    assert bundle[3] == bundle[4] == expect_sum

    tuples_per_s = 2 * n / best_pipe
    ref_tuples_per_s = (2 << 27) / (REFERENCE_BUILD_PROBE_US / 1e6)
    return {
        "metric": "htm_adaptive_build_probe_local_shuffle_2^%d" % log2_n,
        "value": round(tuples_per_s / 1e6, 1),
        "unit": "Mtuples/s",
        "vs_baseline": round(tuples_per_s / ref_tuples_per_s, 2),
        "seconds": best_pipe,
        "single_run_seconds": best,
        "single_run_vs_baseline": round((2 * n / best) / ref_tuples_per_s, 2),
        "pipeline_depth": pipe,
        "device": torch.cuda.get_device_name(),
    }


def main():
    print(json.dumps(measure(
        log2_n=int(os.environ.get("BENCH_LOG2_N", "27")),
        window=int(os.environ.get("BENCH_WINDOW", "16")),
        reps=int(os.environ.get("BENCH_REPS", "3")),
        pipe=int(os.environ.get("BENCH_PIPE", "5")))))


if __name__ == "__main__":
    main()
