"""K7: key-value global sort of a power-of-two count of tiles.

Counterpart of ``htm_hashjoin_tpu/ops/pallas/join_kernels.py:
global_sort_kv_tiles``, the Wisconsin partition split's sort
(``wisconsin/partitioner.py:_reorder_rot2_kv``).  On CUDA tensors
``global_sort_kv_tiles`` runs the bitonic network in two hand-written
kernels: K7a (``sort_kv_tiles``, ``csrc/sort_kv_tiles.cu``) sorts blocks of
up to ``GSORT_KV_BLOCK`` pairs in alternating directions (phase A), then K7b
(``csrc/global_sort_kv.cu``) runs every longer level in place, up to
``GSORT_KV_BITS`` cross-block stages a pass.  On CPU tensors it runs the
plain version, a stable ``torch.sort`` of the keys and a gather of the
values; any other device raises, and nothing falls back.

The network is not stable on equal keys, as on the TPU
(``join_kernels.py:732-734``): the port is held to the sorted keys, and to
the values as a multiset within each key.
"""

from __future__ import annotations

import torch

from . import _args
from .sort_kv_tiles import sort_kv_tiles

GSORT_KV_BLOCK = 16384   # phase A's block: the most pairs K7a holds
GSORT_KV_BITS = 3        # cross-block stages a K7b pass holds, as the TPU's
                         # GSORT_KV_BITS (join_kernels.py:489)

LAUNCHES = 0   # K7b launches (each runs all levels past phase A)


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
    MAXI32, values with anything) by key ascending, each value moving with
    its key.  Returns new ``(keys, vals)`` tensors."""
    dev = _check(keys, vals, tile)
    if not _args.runs_kernel("global_sort_kv_tiles", dev):
        return global_sort_kv_ref(keys, vals)
    n = keys.numel()
    block = min(n, GSORT_KV_BLOCK)
    keys_out, vals_out = sort_kv_tiles(keys, vals, tile=block,
                                       alternate=n > block)
    if n > block:
        _launch(keys_out, vals_out, n, block)
    return keys_out, vals_out


def _launch(keys, vals, n, block):
    global LAUNCHES
    _args.aligned("global_sort_kv_tiles", keys=keys, vals=vals)
    _args.launch("global_sort_kv_tiles", "htm_global_sort_kv_levels",
                 keys.device, keys.data_ptr(), vals.data_ptr(), n, block,
                 GSORT_KV_BITS)
    LAUNCHES += 1
