"""Experiment harness: named parameter grids mirroring the reference's
experiments/*.sh sweeps, and a one-process runner replacing runner.sh
(SURVEY.md §2.1 L5), and ``report``, which summarises their logs.
Counterpart of ``htm_hashjoin_tpu/harness``."""

from .grids import GRIDS, RUNNER_ORDER
from .runner import run_all, run_config, run_grid

__all__ = ["GRIDS", "RUNNER_ORDER", "run_all", "run_config", "run_grid"]
