"""1..N with every key moved fewer than ``cfg.shuffle_range`` places
(``DataGen.hpp:96-115``): a stable sort of the positions by
``i + U[0, window)``, as the port's ``local_shuffled_keys`` draws them."""

import torch

SORTED = False


def keys(n, cfg, rng, state=None):
    window = cfg.shuffle_range
    if window <= 1:
        return torch.arange(1, n + 1, dtype=torch.int32, device=rng.device)
    rank = torch.randint(0, window, (n,), generator=rng, dtype=torch.int32,
                         device=rng.device)
    rank += torch.arange(n, dtype=torch.int32, device=rng.device)
    order = torch.sort(rank, stable=True).indices
    del rank
    return order.to(torch.int32).add_(1)
