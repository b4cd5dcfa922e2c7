"""Sanity-fixture microbenchmarks (SURVEY.md §4 item 6).

Counterpart of ``htm_hashjoin_tpu/benchmarks``:

  testbed  - device-memory copy bandwidth (TestBed.cpp:10-38: 2^27 x 8 B
             parallel memcpy timing; here a device-to-device copy).
  simple   - chunk-size overhead sweep (simple.cpp:18-110: single-thread
             transaction overhead and capacity aborts per tSize; here the
             optimistic build's per-chunk failure fraction and time).
"""

from .testbed import memory_bandwidth
from .simple import chunk_sweep

__all__ = ["memory_bandwidth", "chunk_sweep"]
