"""Chunk-size sweep: simple.cpp:18-110 re-done for the optimistic build.

Counterpart of ``htm_hashjoin_tpu/benchmarks/simple.py``.  The reference's
single-thread microbench sweeps transaction size and reports abort rates
and per-transaction overhead (isolating HTM capacity aborts from
concurrency).  Here the sweep is over the optimistic build's chunk
granularity: the per-chunk failure fraction (the abort-rate statistic that
drives HTM_ADAPT, HTMHashBuild.hpp:196-211) and the build's time.  On
dense unique keys with locality the fraction stays 0, like low-tSize HTM.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List

from ..data.generators import local_shuffled_keys
from ..joins.common import htm_num_buckets
from ..ops import insert
from ..utils.device import entry_device
from ..utils.timing import fence_outputs


def chunk_sweep(log2_n: int = 20, max_log2_chunk: int = 12,
                shuffle_window: int = 16, seed: int = 0,
                device=None) -> List[Dict]:
    """For each chunk size 2^0..2^max: build optimistically (no retry),
    report the mean and max per-chunk failure fraction plus the build's
    time (the second of two builds, ending in a synchronize)."""
    dev = entry_device(device, "the chunk sweep")
    n = 1 << log2_n
    keys = fence_outputs(local_shuffled_keys(n, shuffle_window, seed, dev))
    num_buckets = htm_num_buckets(n)

    def build():
        return fence_outputs(insert.htm_optimistic_build(
            keys, num_buckets, retry=False).failed_optimistic)

    build()                                     # warm-up
    t0 = time.perf_counter()
    failed = build()
    build_us = (time.perf_counter() - t0) * 1e6

    rows = []
    for i in range(max_log2_chunk + 1):
        chunk = 1 << i
        fracs = insert.chunk_failure_fractions(failed, chunk)
        mean, mx = (float(v) for v in (fracs.mean(), fracs.max()))
        rows.append({
            "benchmark": "simple_chunk_sweep",
            "chunkSize": chunk,
            "meanFailureFraction": mean,
            "maxFailureFraction": mx,
            "buildTimeUsecs": build_us,
            "rSize": n,
            "shuffleWindow": shuffle_window,
        })
    return rows


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--log2N", type=int, default=20)
    p.add_argument("--maxLog2Chunk", type=int, default=12)
    p.add_argument("--shuffleWindow", type=int, default=16)
    a = p.parse_args(argv)
    for row in chunk_sweep(a.log2N, a.maxLog2Chunk, a.shuffleWindow):
        print(json.dumps(row))
    return 0
