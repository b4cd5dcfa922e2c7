"""The rotation packing of the Wisconsin partition split, before K7.

Counterpart of ``htm_hashjoin_tpu/wisconsin/partitioner.py:_rot_pack``,
which XLA fuses into one pass on the TPU.  ``rot_pack`` makes K7's two
input columns (``wisconsin/partitioner.py:_reorder_rot2_kv``): the packed
sort key of every row, padded with MAXI32, and the payload, padded with 0.
On CUDA tensors it launches ``rot_pack_kernel`` (``csrc/split_pack.cu``,
one launch a call, counted in ``LAUNCHES``), which takes each row's shard
id from its index; on CPU tensors it runs the plain version,
``rot_pack_ref``, the JAX package's arithmetic as torch operators.  Any
other device raises; nothing falls back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _args
from ..constants import MAXI32

LAUNCHES = 0   # packs that ran the kernel (the plain path adds none)


class Shards(NamedTuple):
    """The independent split's logical shards (the reference's round-robin
    page split, table.cpp:238-272): row i lies in shard
    ``(i // page_size) % nthreads``."""

    page_size: int
    nthreads: int

    def ids(self, n: int, device) -> torch.Tensor:
        """The int32 shard id of each of ``n`` rows."""
        page = torch.div(torch.arange(n, dtype=torch.int32, device=device),
                         self.page_size, rounding_mode="floor")
        return torch.remainder(page, self.nthreads)


def rot_pack_ref(keys, bias, vmin: int, skip: int, b: int, restbits: int,
                 bias_bits: int, n_pad: int) -> torch.Tensor:
    """Rotation packing for a pure-bitfield ModuloHash: bucket =
    ((key-min) & mask) >> skip is a bit-slice of v = key-min, so
    t = (bucket << (bias_bits+restbits)) | (bias << restbits) | rest(v)
    is an int32 sort key ordered by (bucket, bias, key) — partition id,
    secondary rank AND key in one value (bias carries the Independent
    partitioner's shard id; bias_bits = 0 when there is none).  Returns
    t padded to n_pad with MAXI32 (sorts last)."""
    v = keys.to(torch.int32) - vmin
    bucket = (v >> skip) & ((1 << b) - 1)
    hi = (v >> (skip + b)) << skip
    lo = v & ((1 << skip) - 1)
    t = (bucket << (bias_bits + restbits)) | (hi | lo)
    if bias_bits:
        t |= bias.to(torch.int32) << restbits
    return torch.cat([t, torch.full((n_pad - t.shape[0],), MAXI32,
                                    dtype=torch.int32, device=t.device)])


def check_layout(fn: str, vmin: int, skip: int, b: int, restbits: int,
                 bias_bits: int) -> None:
    """The kernels' bit-field layout: an int32 ``vmin`` and shifts of 31
    bits at most, as the plain versions' int32 operators need."""
    if not -2**31 <= vmin < 2**31:
        raise ValueError(f"{fn}: vmin {vmin} is not an int32")
    if (min(skip, b, restbits, bias_bits) < 0 or skip + b > 31
            or bias_bits + restbits > 31):
        raise ValueError(f"{fn}: bit widths skip {skip}, b {b}, restbits "
                         f"{restbits}, bias_bits {bias_bits} shift past 31 "
                         f"bits")


def _check(keys, payload, bias, vmin, skip, b, restbits, bias_bits, n_pad):
    tensors = dict(keys=keys) if payload is None else dict(keys=keys,
                                                           payload=payload)
    dev = _args.int32_vectors("rot_pack", **tensors)
    n = keys.numel()
    if payload is not None and payload.numel() != n:
        raise ValueError("rot_pack: keys and payload differ in length")
    if not n <= n_pad <= 1 << 31:
        raise ValueError(f"rot_pack: n_pad must lie in [{n}, 2^31], got "
                         f"{n_pad}")
    check_layout("rot_pack", vmin, skip, b, restbits, bias_bits)
    if not (bias is None and bias_bits == 0 or isinstance(bias, Shards)):
        raise ValueError("rot_pack: the kernel takes the shard ids as "
                         "Shards (from each row's index), or none with "
                         "bias_bits 0")
    if bias is not None and not (1 <= bias.page_size < 1 << 31
                                 and 1 <= bias.nthreads < 1 << 31):
        raise ValueError(f"rot_pack: {bias} out of range")
    return dev


def rot_pack(keys: torch.Tensor, payload, bias, vmin: int, skip: int, b: int,
             restbits: int, bias_bits: int, n_pad: int):
    """K7's input columns for the n rows of ``keys`` (int32): ``(t, pay)``,
    t the packed keys of ``rot_pack_ref`` padded with MAXI32 to ``n_pad``,
    pay ``payload`` padded with 0 to ``n_pad`` (``payload`` itself when n
    == n_pad; None without a payload).  ``bias``: None (with ``bias_bits``
    0), a ``Shards``, or, for the plain version only, an int32 tensor of
    shard ids."""
    global LAUNCHES
    n = keys.shape[0]
    if not _args.runs_kernel("rot_pack", keys.device):
        if isinstance(bias, Shards):
            bias = bias.ids(n, keys.device)
        t = rot_pack_ref(keys, keys if bias is None else bias, vmin, skip, b,
                         restbits, bias_bits, n_pad)
        if payload is None or n == n_pad:
            return t, payload
        return t, torch.cat([payload.to(torch.int32),
                             payload.new_zeros((n_pad - n,),
                                               dtype=torch.int32)])
    dev = _check(keys, payload, bias, vmin, skip, b, restbits, bias_bits,
                 n_pad)
    t = torch.empty(n_pad, dtype=torch.int32, device=dev)
    pay_out = (torch.empty_like(t) if payload is not None and n < n_pad
               else None)
    shards = bias if bias is not None else Shards(1, 1)
    _args.launch("rot_pack", "htm_rot_pack", dev, keys.data_ptr(),
                 _args.ptr(payload if pay_out is not None else None), n,
                 n_pad, vmin, skip, b, restbits, bias_bits, shards.page_size,
                 shards.nthreads, t.data_ptr(), _args.ptr(pay_out))
    LAUNCHES += 1
    return t, payload if pay_out is None else pay_out
