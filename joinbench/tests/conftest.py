"""The benchmark's CPU tests: the checkout's root on the path, and small
cells (the tests' own sizes) that run the port's plain versions."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from joinbench import cells, loop  # noqa: E402

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]
# the cells whose configuration names no other entry than join_step
JOIN_STEP_CELLS = [
    w["name"] for w in cells.benchmark()["workloads"]
    if cells.config_file(w["config"]).get("entry", cells.DEFAULT_ENTRY)
    == "join_step"]


def small_cell(name):
    """The cell at its configuration file's ``small_argv``: sizes a test
    run holds.  The three join_step deployments' |R| = 2^17 keeps the sum of
    R's keys above 2^31, so 32-bit accumulators (the control) still wrap."""
    config = next(w["config"] for w in cells.benchmark()["workloads"]
                  if w["name"] == name)
    return cells.load(name, cells.config_file(config)["small_argv"])


def cpu_run(name, seed=2**31 + 7, seconds=0.05, traced=False, **kw):
    return loop.run(small_cell(name), seed, seconds, traced, "cpu",
                    time.perf_counter(), **kw)


@pytest.fixture
def cuda():
    """Skips the test without a CUDA device (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
