"""K7a: per-block key-value sort, phase A of the TPU's key-value global
sort.

Counterpart of ``htm_hashjoin_tpu/ops/pallas/join_kernels.py:
_sort_kv_tiles_jit``.  ``sort_kv_tiles`` runs the hand-written CUDA kernel
(``csrc/sort_kv_tiles.cu``) on CUDA tensors and the plain torch version
``sort_kv_tiles_ref`` on CPU tensors; it raises on any other device and
never falls back from one to the other.  Both are stable, descending tiles
included (equal keys keep their input order), so the kernel equals the
plain version bit for bit; the TPU's network is not stable, so the two
agree with JAX on the keys, and on the values as a multiset within each key
of each tile.  The port's key-value global sort (K7, a radix sort) needs no
phase A, so no join path runs this kernel.
"""

from __future__ import annotations

import torch

from . import _args

# A block holds its tile as 64-bit (key, row) composites in registers, and
# in shared memory (227 KB a block) their exchange buffer and the tile's
# values, 13 bytes a pair with padding: up to 16384 pairs.
KERNEL_TILES = (2048, 4096, 8192, 16384)
MAX_TILE = KERNEL_TILES[-1]   # the largest block, the one chip_smoke.py times

LAUNCHES = 0   # kernel launches by sort_kv_tiles (the plain path adds none)


def _check(keys, vals, tile):
    dev = _args.int32_vectors("sort_kv_tiles", keys=keys, vals=vals)
    if vals.numel() != keys.numel():
        raise ValueError("sort_kv_tiles: keys and vals differ in length")
    return dev, _args.n_tiles("sort_kv_tiles", keys, tile, min_tile=2)


def sort_kv_tiles_ref(keys: torch.Tensor, vals: torch.Tensor, *, tile: int,
                      alternate: bool = False):
    """Plain torch version of K7a: each tile's keys sorted ascending (odd
    tiles descending with ``alternate``) by a stable sort, values
    gathered along."""
    _, n_tiles = _check(keys, vals, tile)
    k = keys.view(n_tiles, tile)
    v = vals.view(n_tiles, tile)
    ks, idx = torch.sort(k, dim=1, stable=True)
    if alternate:
        ks[1::2], idx[1::2] = torch.sort(k[1::2], dim=1, descending=True,
                                         stable=True)
    return ks.reshape(-1), torch.gather(v, 1, idx).reshape(-1)


def sort_kv_tiles(keys: torch.Tensor, vals: torch.Tensor, *, tile: int,
                  alternate: bool = False):
    """Sort every ``tile``-pair tile of (``keys``, ``vals``) ((F*tile,)
    int32 each) by key, ascending, or descending on odd tiles with
    ``alternate`` (the TPU's "bitonic_alt"); each value moves with its key.
    Returns new ``(keys, vals)`` tensors."""
    dev, n_tiles = _check(keys, vals, tile)
    if not _args.runs_kernel("sort_kv_tiles", dev):
        return sort_kv_tiles_ref(keys, vals, tile=tile, alternate=alternate)
    _args.kernel_tile("sort_kv_tiles", tile, KERNEL_TILES)
    _args.aligned("sort_kv_tiles", keys=keys, vals=vals)
    keys_out = torch.empty_like(keys)
    vals_out = torch.empty_like(vals)
    if n_tiles:
        _launch(keys, vals, keys_out, vals_out, n_tiles, tile, alternate)
    return keys_out, vals_out


def _launch(keys, vals, keys_out, vals_out, n_tiles, tile, alternate):
    global LAUNCHES
    _args.launch("sort_kv_tiles", "htm_sort_kv_tiles", keys.device,
                 keys.data_ptr(), vals.data_ptr(), keys_out.data_ptr(),
                 vals_out.data_ptr(), n_tiles, tile, int(alternate))
    LAUNCHES += 1
