"""K7: key-value global sort of a power-of-two count of tiles.

Counterpart of ``htm_hashjoin_tpu/ops/pallas/join_kernels.py:
global_sort_kv_tiles``, the Wisconsin partition split's sort
(``wisconsin/partitioner.py:_reorder_rot2_kv``).  On CUDA tensors
``global_sort_kv_tiles`` runs the hand-written stable LSD radix sort with
the value riding (``csrc/radix_sort.cu`` through ``radix_sort.sort_pairs``:
one histogram launch and four scatter passes, one count in ``LAUNCHES`` a
sort).  On CPU tensors it runs the plain version, a stable ``torch.sort``
of the keys and a gather of the values; any other device raises, and
nothing falls back.

Both are stable, so they agree bit for bit.  The TPU's bitonic network is
not stable on equal keys (``join_kernels.py:732-734``): against it the port
is held to the sorted keys, and to the values as a multiset within each
key.
"""

from __future__ import annotations

import torch

from . import _args, radix_sort

LAUNCHES = 0   # kernel sorts by global_sort_kv_tiles (the plain path adds none)


def global_sort_kv_ref(keys: torch.Tensor, vals: torch.Tensor):
    """Plain torch version: keys sorted ascending by a stable sort, values
    gathered along."""
    keys_s, order = torch.sort(keys, stable=True)
    return keys_s, vals[order]


def _check(keys, vals, tile):
    dev = _args.int32_vectors("global_sort_kv_tiles", keys=keys, vals=vals)
    if vals.numel() != keys.numel():
        raise ValueError("global_sort_kv_tiles: keys and vals differ in "
                         "length")
    n_tiles = _args.n_tiles("global_sort_kv_tiles", keys, tile, min_tile=2)
    if n_tiles == 0 or n_tiles & (n_tiles - 1):
        raise ValueError("global_sort_kv_tiles: the tile count must be a "
                         f"power of two, got {n_tiles}")
    return dev


def global_sort_kv_tiles(keys: torch.Tensor, vals: torch.Tensor, *,
                         tile: int):
    """Sort (``keys``, ``vals``) ((2^k * tile,) int32 each; pad keys with
    MAXI32, values with anything) by key ascending, stably, each value
    moving with its key.  Returns new ``(keys, vals)`` tensors."""
    global LAUNCHES
    dev = _check(keys, vals, tile)
    if not _args.runs_kernel("global_sort_kv_tiles", dev):
        return global_sort_kv_ref(keys, vals)
    out = radix_sort.sort_pairs("global_sort_kv_tiles", keys, vals)
    LAUNCHES += 1
    return out
