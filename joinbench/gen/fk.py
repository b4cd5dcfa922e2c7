"""Foreign keys over the primary keys 1..|R| (mc ``generator.c:408-445``,
``create_relation_fk``): whole permutations of 1..|R| one after another,
then the first keys of one more for the remainder, so every R key appears
floor or ceil of |S| / |R| times."""

import torch

SORTED = False


def keys(n, cfg, rng, state=None):
    domain = cfg.r_size
    out = torch.empty(n, dtype=torch.int32, device=rng.device)
    for lo in range(0, n, domain):
        m = min(domain, n - lo)
        perm = torch.randperm(domain, generator=rng, dtype=torch.int32,
                              device=rng.device)
        out[lo:lo + m] = perm[:m].add_(1)
    return out
