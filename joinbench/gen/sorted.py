"""1..N in order (the testbed's default S, ``main.cpp:93``)."""

import torch

SORTED = True


def keys(n, cfg, rng, state=None):
    return torch.arange(1, n + 1, dtype=torch.int32, device=rng.device)
