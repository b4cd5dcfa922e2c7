"""Experiment grids: the reference's experiments/*.sh parameter sweeps
(SURVEY.md §2.1 "Experiment harness") as data.

Counterpart of ``htm_hashjoin_tpu/harness/grids.py``, kept as the port's
own copy (pure JoinConfig data; the port imports nothing of the JAX
package), config for config.

Each grid is a generator of JoinConfig objects mirroring one script:

  AtomicsVsHTMVsNoCC          experiments/AtomicsVsHTMVsNoCC.sh
  SizeToAbortsAndTimeSorted   experiments/SizeToAbortsAndTimeSorted.sh
  SizeToAbortsAndTimeShuffled experiments/SizeToAbortsAndTimeShuffled.sh
  TSizeAndShuffleWindowstoTime experiments/TSizeAndShuffleWindowstoTime.sh
  adaptive / adaptive2        experiments/adaptive.sh, adaptive2.sh
  motivation                  experiments/motivation.sh (PRO vs builds)
  probe                       experiments/probe.sh (build+probe variants)
  track                       experiments/track.sh (failure histograms)

The reference pins rSize = 2^27 and sweeps shuffleRange over 2^0..2^27;
grids here take a ``scale`` (log2 rSize) so the same sweep runs at a small
scale on the CPU and at the reference's on the card.  The compile-time
binary variants (noretry/retry/adaptive/adaptiveWithProbe/track,
config.h:1-18) map to JoinConfig flags.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator

from ..config import Algo, Distribution, JoinConfig


def _windows(scale: int) -> Iterator[int]:
    """shuffleRange 2^0 .. 2^scale (scripts: seq 0 27)."""
    for i in range(scale + 1):
        yield 1 << i


def atomics_vs_htm_vs_nocc(scale: int) -> Iterator[JoinConfig]:
    n = 1 << scale
    for algo in (Algo.NOCC, Algo.ATOMIC, Algo.HTM):
        for dist in (Distribution.SORTED, Distribution.SHUFFLE):
            yield JoinConfig(algo=algo, r_size=n, probe_length=4,
                             transaction_size=1 if algo == Algo.HTM else 16,
                             data_distr=dist, retry=False, enable_probe=False)


def size_to_aborts_sorted(scale: int) -> Iterator[JoinConfig]:
    n = 1 << scale
    for i in range(13):  # tSize 2^0..2^12
        yield JoinConfig(algo=Algo.HTM, r_size=n, transaction_size=1 << i,
                         probe_length=4, data_distr=Distribution.SORTED,
                         retry=False, enable_probe=False)


def size_to_aborts_shuffled(scale: int) -> Iterator[JoinConfig]:
    n = 1 << scale
    for i in range(10):  # tSize 2^0..2^9
        yield JoinConfig(algo=Algo.HTM, r_size=n, transaction_size=1 << i,
                         probe_length=4, data_distr=Distribution.SHUFFLE,
                         retry=False, enable_probe=False)


def tsize_and_windows(scale: int) -> Iterator[JoinConfig]:
    n = 1 << scale
    for t in (1, 4, 8, 16, 32, 64):
        for w in _windows(scale):
            yield JoinConfig(algo=Algo.HTM, r_size=n, transaction_size=t,
                             probe_length=4,
                             data_distr=Distribution.LOCAL_SHUFFLE,
                             shuffle_range=w, retry=False, enable_probe=False)


def adaptive(scale: int) -> Iterator[JoinConfig]:
    """adaptive.sh: the retry binary over the same tSize × window grid."""
    for cfg in tsize_and_windows(scale):
        yield dataclasses.replace(cfg, retry=True)


def adaptive2(scale: int) -> Iterator[JoinConfig]:
    """adaptive2.sh: the adaptive binary, tSize 16, window sweep."""
    n = 1 << scale
    for w in _windows(scale):
        yield JoinConfig(algo=Algo.HTM, r_size=n, transaction_size=16,
                         probe_length=4, data_distr=Distribution.LOCAL_SHUFFLE,
                         shuffle_range=w, retry=True, adaptive=True,
                         enable_probe=False)


def motivation(scale: int) -> Iterator[JoinConfig]:
    """motivation.sh: PRO (radix, build-only: --s-size=2) vs the three builds
    across locality windows."""
    n = 1 << scale
    for w in _windows(scale):
        yield JoinConfig(algo=Algo.RADIX, r_size=n, s_size=2,
                         data_distr=Distribution.PK_LSHUFFLE, shuffle_range=w,
                         enable_probe=False)
    for algo in (Algo.NOCC, Algo.ATOMIC, Algo.HTM):
        for w in _windows(scale):
            yield JoinConfig(algo=algo, r_size=n, probe_length=4,
                             transaction_size=16,
                             data_distr=Distribution.LOCAL_SHUFFLE,
                             shuffle_range=w, retry=True, adaptive=True,
                             enable_probe=False)


def probe_grid(scale: int) -> Iterator[JoinConfig]:
    """probe.sh: the adaptiveWithProbe binary — full build+probe."""
    n = 1 << scale
    for algo in (Algo.NOCC, Algo.ATOMIC, Algo.HTM):
        for w in _windows(scale):
            yield JoinConfig(algo=algo, r_size=n, probe_length=4,
                             transaction_size=16,
                             data_distr=Distribution.LOCAL_SHUFFLE,
                             shuffle_range=w, retry=True, adaptive=True,
                             enable_probe=True)


def track(scale: int) -> Iterator[JoinConfig]:
    """track.sh: TM_TRACK failure-histogram builds, tSize {4, 8}."""
    n = 1 << scale
    for t in (4, 8):
        for w in _windows(scale):
            yield JoinConfig(algo=Algo.HTM, r_size=n, transaction_size=t,
                             probe_length=4,
                             data_distr=Distribution.LOCAL_SHUFFLE,
                             shuffle_range=w, retry=False, track=True,
                             enable_probe=False)


def skewprobe(scale: int) -> Iterator[JoinConfig]:
    """Skewed-probe grid (BASELINE.json config-5's single-device analog;
    no reference script exists — the reference never probes with a
    skewed S at the top level, only mc's -z flag builds one,
    mc/src/main.c:393-412).  PK build side probed by a zipf S over a sweep
    of skew parameters: every point exercises the banded engine's
    sort-probe-side device sort (S arrives unsorted) and, at high skew, the
    duplicate-heavy general count + mass-overflow replan."""
    n = 1 << scale
    for algo in (Algo.HTM, Algo.ATOMIC, Algo.NOCC):
        for z in (0.25, 0.5, 0.75, 1.0, 1.25):
            yield JoinConfig(algo=algo, r_size=n, transaction_size=16,
                             probe_length=4, data_distr=Distribution.PK,
                             s_distr=Distribution.ZIPF, zipf_param=z,
                             retry=True, enable_probe=True)


GRIDS: Dict[str, Callable[[int], Iterator[JoinConfig]]] = {
    "AtomicsVsHTMVsNoCC": atomics_vs_htm_vs_nocc,
    "SizeToAbortsAndTimeSorted": size_to_aborts_sorted,
    "SizeToAbortsAndTimeShuffled": size_to_aborts_shuffled,
    "TSizeAndShuffleWindowstoTime": tsize_and_windows,
    "adaptive": adaptive,
    "adaptive2": adaptive2,
    "motivation": motivation,
    "probe": probe_grid,
    "track": track,
    "skewprobe": skewprobe,
}

# runner.sh's execution order (experiments/runner.sh:3-41), plus the two
# grids the reference ran separately/not at all (track.sh; skewprobe is ours)
RUNNER_ORDER = ["motivation", "SizeToAbortsAndTimeSorted",
                "SizeToAbortsAndTimeShuffled", "TSizeAndShuffleWindowstoTime",
                "AtomicsVsHTMVsNoCC", "adaptive", "adaptive2", "probe",
                "track", "skewprobe"]
