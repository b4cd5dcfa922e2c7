"""The stable LSD radix sort behind K3 and K7 (``csrc/radix_sort.cu``).

``sort_keys`` and ``sort_pairs`` launch the hand-written kernel on CUDA
tensors; ``global_sort.global_sort_tiles`` (K3) and
``global_sort_kv.global_sort_kv_tiles`` (K7) call them and count the
launches.  They allocate what the kernel works in: the output, one
ping-pong buffer of the same size (the four passes go input -> scratch ->
output -> scratch -> output) and the scratch words of the histogram, the
tile counters and the look-back status.

``model_sort`` is a plain model of the kernel's algorithm, step for step,
for the CPU tests only (the wrappers' plain versions are ``torch.sort``):
the sign flip, the four digit histograms from one read, per-tile digit
counts, the exclusive scans across digits and across tiles (what the
look-back computes), the stable ranks within each warp's stripe and the
ping-pong parity.
"""

from __future__ import annotations

import torch

from . import _args, _build

RADIX_BITS = 8
BINS = 1 << RADIX_BITS
PASSES = 32 // RADIX_BITS
THREADS = BINS              # a scatter block: thread d owns digit d
ITEMS = 24                  # keys a thread holds in registers
WARP = 32
TILE_KEYS = THREADS * ITEMS  # keys a scatter block takes (csrc: kTileKeys)
MAX_KEYS = 1 << 32          # keys and offsets are 32-bit unsigned
SIGN_FLIP = 0x80000000


def _check_size(fn: str, n: int) -> None:
    if n >= MAX_KEYS:
        raise ValueError(f"{fn}: the radix sort takes fewer than 2^32 keys, "
                         f"got {n}")


def _scratch(keys: torch.Tensor) -> torch.Tensor:
    words = _build.load_library().htm_radix_sort_scratch_words(keys.numel())
    return torch.empty(words, dtype=torch.int32, device=keys.device)


def sort_keys(fn: str, keys: torch.Tensor) -> torch.Tensor:
    """The stable ascending sort of ``keys`` (a contiguous 1-D int32 CUDA
    tensor, 16-byte aligned) on the card: one launch of the histogram and
    four of the scatter, on the current stream."""
    n = keys.numel()
    _check_size(fn, n)
    _args.aligned(fn, keys=keys)
    out, tmp = torch.empty_like(keys), torch.empty_like(keys)
    scratch = _scratch(keys)
    _args.launch(fn, "htm_radix_sort_keys", keys.device, keys.data_ptr(),
                 out.data_ptr(), tmp.data_ptr(), scratch.data_ptr(),
                 scratch.numel(), n)
    return out


def sort_pairs(fn: str, keys: torch.Tensor, vals: torch.Tensor):
    """As ``sort_keys``, each value of ``vals`` moving with its key; returns
    ``(keys, vals)``."""
    n = keys.numel()
    _check_size(fn, n)
    _args.aligned(fn, keys=keys)
    keys_out, vals_out = torch.empty_like(keys), torch.empty_like(vals)
    keys_tmp, vals_tmp = torch.empty_like(keys), torch.empty_like(vals)
    scratch = _scratch(keys)
    _args.launch(fn, "htm_radix_sort_pairs", keys.device, keys.data_ptr(),
                 vals.data_ptr(), keys_out.data_ptr(), vals_out.data_ptr(),
                 keys_tmp.data_ptr(), vals_tmp.data_ptr(), scratch.data_ptr(),
                 scratch.numel(), n)
    return keys_out, vals_out


# ---------------------------------------------------------------------------
# The plain model (CPU tests only)

def flip(keys: torch.Tensor) -> torch.Tensor:
    """int32 keys -> their order-preserving unsigned words (as int64)."""
    return (keys.to(torch.int64) & 0xFFFFFFFF) ^ SIGN_FLIP


def digits(u: torch.Tensor, p: int) -> torch.Tensor:
    return (u >> (RADIX_BITS * p)) & (BINS - 1)


def histograms(u: torch.Tensor) -> torch.Tensor:
    """(PASSES, BINS) counts of every digit of every key, from one read."""
    return torch.stack([torch.bincount(digits(u, p), minlength=BINS)
                        for p in range(PASSES)])


def exclusive(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim) - x


def tile_ranks(d: torch.Tensor, *, items: int = ITEMS,
               threads: int = THREADS):
    """One pass's in-tile arithmetic over the digits ``d`` (n,), as the
    kernel does it: tiles of ``threads * items`` keys, each warp holding a
    stripe of ``32 * items`` consecutive keys, the ragged tail read as digit
    255.  Returns (counts (tiles, BINS): each tile's digit counts, the tail
    left out; pos (n,): each key's place in its tile's digit-ordered
    staging, from its digit's start, its warp's offset and its stable rank
    within the warp)."""
    n = d.numel()
    tile, stripe = threads * items, WARP * items
    tiles = -(-n // tile)
    padded = torch.full((tiles * tile,), BINS - 1, dtype=torch.int64)
    padded[:n] = d
    onehot = torch.nn.functional.one_hot(padded, BINS).view(
        tiles, tile // stripe, stripe, BINS)
    rank = exclusive(onehot, 2)                       # within the warp
    warp_counts = onehot.sum(2)                       # (tiles, warps, BINS)
    warp_off = exclusive(warp_counts, 1)
    counts = warp_counts.sum(1)
    counts[-1, BINS - 1] -= tiles * tile - n
    digit_start = exclusive(counts, 1)                # across digits
    staged = (digit_start[:, None, None, :] + warp_off[:, :, None, :]
              + rank)
    pos = staged.view(-1, BINS).gather(1, padded[:, None]).view(-1)[:n]
    return counts, pos


def scatter_pass(keys, vals, p: int, hist: torch.Tensor, *, items: int = ITEMS,
                 threads: int = THREADS):
    """Pass ``p``: the keys (and values) ordered stably by digit ``p``
    (``hist``: the pass's BINS digit counts).  A key goes to its digit's
    bucket start (an exclusive scan of the histogram), plus the digit's
    count over earlier tiles (the exclusive scan across tiles that the
    look-back computes), plus its staged place past its digit's start in
    its tile."""
    n = keys.numel()
    d = digits(flip(keys), p)
    counts, pos = tile_ranks(d, items=items, threads=threads)
    t = torch.arange(n) // (threads * items)
    bucket = exclusive(hist, 0)
    before = exclusive(counts, 0)                     # the look-back
    digit_start = exclusive(counts, 1)
    dest = bucket[d] + before[t, d] + pos - digit_start[t, d]
    out_k = torch.empty_like(keys)
    out_k[dest] = keys
    if vals is None:
        return out_k, None
    out_v = torch.empty_like(vals)
    out_v[dest] = vals
    return out_k, out_v


def model_sort(keys: torch.Tensor, vals: torch.Tensor | None = None, *,
               items: int = ITEMS, threads: int = THREADS):
    """The kernel's sort on CPU tensors: four passes, LSB first, writing the
    scratch buffer and the output in turn, from one histogram of the input.
    Returns the output buffer: (keys, vals or None)."""
    hist = histograms(flip(keys))
    bufs = [None, None]                               # [scratch, output]
    src = (keys, vals)
    for p in range(PASSES):
        bufs[p % 2] = scatter_pass(*src, p, hist[p], items=items,
                                   threads=threads)
        src = bufs[p % 2]
    return bufs[1]
