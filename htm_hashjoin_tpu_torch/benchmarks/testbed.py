"""Device-memory bandwidth microbench: TestBed.cpp:10-38 re-done for the card.

Counterpart of ``htm_hashjoin_tpu/benchmarks/testbed.py``.  The reference
times a TBB-parallel memcpy of 2^27 x 8 B to sanity-check the machine's
DRAM bandwidth, the roofline every build phase is judged against.  Here the
fixture is a device-to-device copy of 2^log2_elems int32 keys, which reads
and writes every byte, so GB/s = 2 x bytes / time: the card's own copy
rate, which the ``--counters`` bandwidths are held under.
"""

from __future__ import annotations

import json
import time
from typing import Dict

import torch

from ..utils.device import entry_device


def _chain_seconds(fn, dev: torch.device) -> float:
    """Seconds of one call of ``fn``: CUDA events around it on a card, the
    host clock on the CPU (where the work is done when fn returns)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3


def _fenced_seconds(fn, dev: torch.device) -> float:
    """Host seconds of one call of ``fn`` followed by a synchronize."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def memory_bandwidth(log2_elems: int = 27, reps: int = 5, chain: int = 16,
                     device=None) -> Dict[str, float]:
    """Copy 2^log2_elems int32 elements on the device; report GB/s
    (read + write).

    Two figures: ``gbps`` from a chain of ``chain`` dependent copies
    between two buffers (each copy reads what the previous one wrote),
    timed as one span, best of ``reps``; ``gbpsSingleFenced`` from one copy
    followed by a synchronize on the host clock, best of ``reps`` (the
    reference's TestBed.cpp:10-38 shape, launch and fence included)."""
    dev = entry_device(device, "the testbed")
    n = 1 << log2_elems
    a = torch.arange(n, dtype=torch.int32, device=dev)
    b = torch.empty_like(a)

    def chained():
        for i in range(chain):
            if i % 2:
                a.copy_(b)
            else:
                b.copy_(a)

    chained()                                   # warm-up
    per_copy = min(_chain_seconds(chained, dev) for _ in range(reps)) / chain
    single = min(_fenced_seconds(lambda: b.copy_(a), dev)
                 for _ in range(reps))
    nbytes = n * a.element_size()
    return {
        "benchmark": "testbed_memcpy",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "elems": n,
        "bytes": nbytes,
        "chain": chain,
        "bestTimeUsecs": per_copy * 1e6,
        "gbps": 2 * nbytes / per_copy / 1e9,   # read + write traffic
        "singleFencedTimeUsecs": single * 1e6,
        "gbpsSingleFenced": 2 * nbytes / single / 1e9,
    }


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--log2Elems", type=int, default=27)
    p.add_argument("--reps", type=int, default=5)
    a = p.parse_args(argv)
    print(json.dumps(memory_bandwidth(a.log2Elems, a.reps)))
    return 0
