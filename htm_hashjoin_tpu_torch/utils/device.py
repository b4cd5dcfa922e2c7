"""The device an entry point runs on.

The port's entry points (the CLI, the multijoin driver, the harness, the
microbenchmarks) run on the card.  A caller that wants the kernels' plain
versions passes a CPU device, as the tests do; nothing falls back to the
CPU by itself.
"""

from __future__ import annotations

import torch


def entry_device(device, what: str) -> torch.device:
    """``device`` when given; else the CUDA device, or a RuntimeError
    naming ``what`` when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on a CUDA device and none is "
                           f"available (pass device= to run the plain "
                           f"versions on the CPU)")
    return torch.device("cuda")
