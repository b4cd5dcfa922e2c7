"""Grid runner: experiments/runner.sh re-designed as one process.

Counterpart of ``htm_hashjoin_tpu/harness/runner.py``.  The reference runs
each grid script N=5 times, one process per grid point (runner.sh:3-41),
paying binary startup and data regeneration at every point.  Here a whole
grid runs in one process on one device (the card unless the caller passes
another), and each repetition writes one JSON line a point to
``<name>_log<rep>``: the log-file convention the reference keeps in
experiments/new_backup/*_log{1..5}, so downstream diffing works the same
way.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import List, Optional

import torch

from ..config import JoinConfig
from ..data.generators import build_relations
from ..joins import DISPATCH
from ..parallel.dist_join import distributed_join
from ..utils.device import entry_device
from ..utils.timing import fence_outputs
from .grids import GRIDS, RUNNER_ORDER

# Generated relations reused across consecutive grid points that share
# generator inputs (a tSize sweep regenerates nothing; window-inner sweeps
# regenerate at every point).  Two entries hold two R, S pairs: 2 GiB on
# the card at 2^27.
_GEN_CACHE: "dict[tuple, tuple]" = {}
_GEN_CACHE_CAP = 2

# run_all's log directory: beside the JAX package's experiments/logs (same
# file names), so that the two runners' logs diff and neither overwrites
# the other's
LOG_DIR = "experiments/logs_torch"


def _relations_for(cfg: JoinConfig, dev: torch.device):
    key = (cfg.data_distr, cfg.r_size, cfg.s_size, cfg.distinct_keys,
           cfg.shuffle_range, cfg.seed, cfg.zipf_param, cfg.s_seed,
           cfg.s_distr, dev)
    if key not in _GEN_CACHE:
        if len(_GEN_CACHE) >= _GEN_CACHE_CAP:
            _GEN_CACHE.pop(next(iter(_GEN_CACHE)))
        r, s = build_relations(cfg, dev)
        # generation is not part of the timed phases
        fence_outputs((r.keys, s.keys))
        _GEN_CACHE[key] = (r, s)
    return _GEN_CACHE[key]


def clear_cache() -> None:
    """Drop the cached relations (their device memory goes with them)."""
    _GEN_CACHE.clear()


def run_config(cfg: JoinConfig, device=None) -> str:
    """One grid point -> one JSON metrics line (the reference binaries'
    stdout contract, HTMHashBuild.hpp:417-449)."""
    r, s = _relations_for(cfg, entry_device(device, "the harness"))
    if cfg.mesh_shape:
        metrics = distributed_join(r, s, cfg)
    else:
        metrics = DISPATCH[cfg.algo.value](r, s, cfg)
    if cfg.s_distr is not None:
        # self-describing rows for the S-side sweeps (skewprobe): without
        # these the zipf points are indistinguishable in the log
        metrics.extra.setdefault("sDistr", cfg.s_distr.value)
        if cfg.zipf_param is not None:
            metrics.extra.setdefault("zipfParam", cfg.zipf_param)
    return metrics.to_json_line()


def run_grid(name: str, *, scale: int = 20, reps: int = 5,
             out_dir: Optional[str] = None, echo: bool = True,
             pipeline_depth: int = 1, device=None) -> List[str]:
    """Run grid ``name`` ``reps`` times; write <name>_log<i> files when
    out_dir is given.  Returns the last repetition's lines.

    pipeline_depth > 1 switches per-point timing to the sustained-throughput
    shape (enqueue K joins, fence once, bench.py's) on the banded-engine
    paths; single-run times ride along as singleRunTimeInMicroseconds."""
    if name not in GRIDS:
        raise ValueError(f"unknown grid {name!r}; have {sorted(GRIDS)}")
    dev = entry_device(device, "the harness")
    lines: List[str] = []
    for rep in range(1, reps + 1):
        lines = []
        t0 = time.time()
        for cfg in GRIDS[name](scale):
            if pipeline_depth > 1:
                cfg = dataclasses.replace(cfg, pipeline_depth=pipeline_depth)
            line = run_config(cfg, dev)
            lines.append(line)
            if echo:
                print(line, flush=True)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"{name}_log{rep}"), "w") as f:
                f.write("\n".join(lines) + "\n")
        if echo:
            print(f"# {name} rep {rep}/{reps}: {len(lines)} points in "
                  f"{time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    return lines


def run_all(*, scale: int = 20, reps: int = 5,
            out_dir: str = LOG_DIR,
            pipeline_depth: int = 1, device=None) -> None:
    """runner.sh: every grid, N repetitions, logs on disk."""
    for name in RUNNER_ORDER:
        run_grid(name, scale=scale, reps=reps, out_dir=out_dir,
                 pipeline_depth=pipeline_depth, device=device)
