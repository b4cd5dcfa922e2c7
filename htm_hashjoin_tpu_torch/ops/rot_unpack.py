"""The inverse of the Wisconsin split's rotation packing, after K7.

Counterpart of ``htm_hashjoin_tpu/wisconsin/partitioner.py:_rot_unpack``,
which XLA fuses into one pass on the TPU.  ``rot_unpack`` turns K7's sorted
packed keys back into keys and finds the partitions' bounds
(``rot_bounds``: one ``torch.searchsorted`` of a query a partition, torch
glue on every device).  On CUDA tensors the keys come from
``rot_unpack_kernel`` (``csrc/split_pack.cu``, one launch a call, counted
in ``LAUNCHES``); on CPU tensors from the plain version, ``rot_unpack_ref``,
the JAX package's arithmetic as torch operators.  Any other device raises;
nothing falls back.
"""

from __future__ import annotations

import torch

from . import _args
from .rot_pack import check_layout

LAUNCHES = 0   # unpacks that ran the kernel (the plain path adds none)


def rot_bounds(t_s: torch.Tensor, restbits: int, bias_bits: int,
               nparts: int) -> torch.Tensor:
    """(2, nparts) int64 [sizes, offsets] of the partitions of a sorted
    packed stream: partition p starts at the first t >= p << (bias_bits +
    restbits)."""
    n = t_s.shape[0]
    queries = (torch.arange(nparts, dtype=torch.int32, device=t_s.device)
               << (bias_bits + restbits))
    bounds = torch.searchsorted(t_s, queries).long()
    ends = torch.cat([bounds[1:], bounds.new_full((1,), n)])
    return torch.stack([ends - bounds, bounds])


def rot_unpack_ref(t_s, pay_s, vmin: int, skip: int, b: int, restbits: int,
                   bias_bits: int, nparts: int):
    """Invert the rotation packing on the sorted stream + partition bounds
    (partition p starts at the first t >= p << (bias_bits+restbits); the
    bias bits are scheduling metadata and are simply dropped).  Returns
    (keys, payload, (2, nparts) int64 [sizes, offsets])."""
    rest = t_s & ((1 << restbits) - 1)
    bucket = t_s >> (bias_bits + restbits)
    lo = rest & ((1 << skip) - 1)
    hi = (rest >> skip) << (skip + b)
    key_s = (hi | (bucket << skip) | lo) + vmin
    return key_s, pay_s, rot_bounds(t_s, restbits, bias_bits, nparts)


def rot_unpack(t_s: torch.Tensor, pay_s, vmin: int, skip: int, b: int,
               restbits: int, bias_bits: int, nparts: int):
    """``rot_unpack_ref``'s (keys, payload, [sizes, offsets]) of the sorted
    packed keys ``t_s`` (int32) and their payload ``pay_s``, which is
    returned as it is."""
    global LAUNCHES
    if not _args.runs_kernel("rot_unpack", t_s.device):
        return rot_unpack_ref(t_s, pay_s, vmin, skip, b, restbits, bias_bits,
                              nparts)
    dev = _args.int32_vectors("rot_unpack", t_s=t_s)
    check_layout("rot_unpack", vmin, skip, b, restbits, bias_bits)
    key_s = torch.empty_like(t_s)
    bounds = rot_bounds(t_s, restbits, bias_bits, nparts)
    _args.launch("rot_unpack", "htm_rot_unpack", dev, t_s.data_ptr(),
                 t_s.numel(), vmin, skip, b, restbits, bias_bits,
                 key_s.data_ptr())
    LAUNCHES += 1
    return key_s, pay_s, bounds
