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

# sizes a test run holds: |R| = 2^17 keeps the sum of R's keys above 2^31,
# so 32-bit accumulators (the control) still wrap
SMALL = {"adaptive_2e27": ["--rSize", str(1 << 17)],
         "pro_2e24x2e28": ["-r", str(1 << 17), "-s", str(1 << 19)]}
CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


def small_cell(name):
    return cells.load(name, SMALL[name.split(".")[0]])


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
