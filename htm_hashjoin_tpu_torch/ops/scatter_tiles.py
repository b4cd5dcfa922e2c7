"""K6: one pass of the multipass radix partition (the run scatter).

Counterpart of ``htm_hashjoin_tpu/ops/pallas/radix_kernels.py:
scatter_tiles``.  ``scatter_tiles`` runs the hand-written CUDA kernel
(``csrc/scatter_tiles.cu``) on CUDA tensors and the plain torch version
``scatter_tiles_ref`` on CPU tensors; it raises on any other device and
never falls back from one to the other.
"""

from __future__ import annotations

import torch

from . import _args
from ..constants import LANES, MAXI32

MAX_FANOUT = 128   # plan entries a tile (the kernel holds them in shared memory)

LAUNCHES = 0   # calls that launched the kernel (the plain path adds none)


def _check(sorted_flat, a_elem, dest_row, tile, out_rows):
    dev = _args.int32_vectors("scatter_tiles", sorted_flat=sorted_flat)
    n_tiles = _args.n_tiles("scatter_tiles", sorted_flat, tile,
                            min_tile=LANES)
    for name, x in (("a_elem", a_elem), ("dest_row", dest_row)):
        if not isinstance(x, torch.Tensor):
            raise TypeError("scatter_tiles takes torch tensors")
        if x.device != dev:
            raise ValueError("scatter_tiles: tensors on different devices")
        if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"scatter_tiles: {name} must be a contiguous "
                             f"(n_tiles, fanout) int32 tensor, got {x.dtype} "
                             f"{tuple(x.shape)}")
    if a_elem.shape != dest_row.shape or a_elem.shape[0] != n_tiles:
        raise ValueError(f"scatter_tiles: a_elem {tuple(a_elem.shape)} and "
                         f"dest_row {tuple(dest_row.shape)} need {n_tiles} "
                         f"rows each, of one fanout")
    fanout = a_elem.shape[1]
    if not 1 <= fanout <= MAX_FANOUT:
        raise ValueError(f"scatter_tiles: fanout must be in 1..{MAX_FANOUT}, "
                         f"got {fanout}")
    if out_rows < 0:
        raise ValueError(f"scatter_tiles: out_rows must be >= 0, got "
                         f"{out_rows}")
    return dev, n_tiles, fanout


def scatter_tiles_ref(sorted_flat, a_elem, dest_row, *, tile: int,
                      out_rows: int) -> torch.Tensor:
    """Plain torch version of K6 (any device): a MAXI32 output of
    ``out_rows`` 128-key rows, then every key i of tile t stored at
    ``dest_row[t,f]*128 + i - a_elem[t,f]`` for its run f (the last f with
    ``a_elem[t,f] <= i``).  A key sent outside the output raises."""
    _, n_tiles, _ = _check(sorted_flat, a_elem, dest_row, tile, out_rows)
    out = torch.full((out_rows * LANES,), MAXI32, dtype=torch.int32,
                     device=sorted_flat.device)
    if not n_tiles:
        return out
    idx = torch.arange(tile, dtype=torch.int32, device=out.device)
    idx = idx.expand(n_tiles, tile).contiguous()
    run = torch.searchsorted(a_elem, idx, right=True).sub_(1).clamp_(min=0)
    shift = dest_row.to(torch.int64) * LANES - a_elem.to(torch.int64)
    pos = (torch.gather(shift, 1, run) + idx).reshape(-1)
    if int(pos.min()) < 0 or int(pos.max()) >= out.numel():
        raise ValueError("scatter_tiles: the plan sends a key outside the "
                         f"{out_rows}-row output")
    out[pos] = sorted_flat
    return out


def scatter_tiles(sorted_flat, a_elem, dest_row, *, tile: int,
                  out_rows: int) -> torch.Tensor:
    """Scatter the digit runs of tile-sorted keys to their partition rows.

    Arguments: ``sorted_flat`` (n_tiles*tile,) int32, each tile sorted;
    ``a_elem`` (n_tiles, F) int32, run f's first key index within its tile
    (``a_elem[t, 0] = 0``, non-decreasing; run f ends where run f+1
    starts, the last at the tile's end); ``dest_row`` (n_tiles, F) int32,
    run f's first output row; ``out_rows`` the output's size in 128-key
    rows.  These are a ``ScatterPlan``'s ``a_elem``, ``dest_row`` and
    ``out_rows`` (``ops/radix_kernels.py``).

    Returns the (out_rows*128,) int32 output, MAXI32 wherever no key
    lands: the bytes of the JAX function's (out_rows, 128) output, flat.
    On CUDA a key sent outside the output is dropped; the plain version
    raises."""
    dev, n_tiles, fanout = _check(sorted_flat, a_elem, dest_row, tile,
                                  out_rows)
    if not _args.runs_kernel("scatter_tiles", dev):
        return scatter_tiles_ref(sorted_flat, a_elem, dest_row, tile=tile,
                                 out_rows=out_rows)
    out = torch.empty((out_rows * LANES,), dtype=torch.int32, device=dev)
    _args.aligned("scatter_tiles", out=out)
    _launch(sorted_flat, a_elem, dest_row, out, n_tiles, tile, fanout)
    return out


def _launch(sorted_flat, a_elem, dest_row, out, n_tiles, tile, fanout):
    global LAUNCHES
    _args.launch("scatter_tiles", "htm_scatter_tiles", sorted_flat.device,
                 sorted_flat.data_ptr(), a_elem.data_ptr(),
                 dest_row.data_ptr(), out.data_ptr(), out.numel(), n_tiles,
                 tile, fanout)
    LAUNCHES += 1
