"""Zipf(``cfg.zipf_param``) keys over the primary keys 1..|R|, drawn as mc's
``genzipf.c:97-158`` draws them: a permuted alphabet, the table of the
cumulative distribution in float64, and for each draw u in [0, 1) the first
rank whose cumulative share reaches u (a binary search), mapped through
the alphabet.  The table is made once a run; the alphabet, as in
``gen_zipf``, anew for each relation, so which tiles of R hold the hot
keys changes from join to join."""

import torch

SORTED = False
BLOCK = 1 << 26   # draws a block: bounds the float64 temporaries


def prepare(cfg, seed, device):
    weights = torch.arange(1, cfg.r_size + 1, dtype=torch.float64,
                           device=device).pow_(-cfg.zipf_param)
    return torch.cumsum(weights, 0).div_(weights.sum())


def keys(n, cfg, rng, cdf):
    alphabet = torch.randperm(cfg.r_size, generator=rng, dtype=torch.int32,
                              device=rng.device).add_(1)
    out = torch.empty(n, dtype=torch.int32, device=rng.device)
    for lo in range(0, n, BLOCK):
        m = min(BLOCK, n - lo)
        u = torch.rand(m, generator=rng, dtype=torch.float64,
                       device=rng.device)
        rank = torch.searchsorted(cdf, u, out_int32=True)
        del u
        out[lo:lo + m] = alphabet[rank.clamp_(max=cfg.r_size - 1)]
    return out
