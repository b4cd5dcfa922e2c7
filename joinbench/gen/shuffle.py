"""1..N globally permuted (``DataGen.hpp:86-95``, ``random_shuffle``)."""

import torch

SORTED = False


def keys(n, cfg, rng, state=None):
    perm = torch.randperm(n, generator=rng, dtype=torch.int32,
                          device=rng.device)
    return perm.add_(1)
