"""The Wisconsin multijoin's partitioned probe and emit, one worker block a
call, under the permutation-build certificate.

Counterpart of the scheduled probe's "perm" route and its unit-count emit
in ``htm_hashjoin_tpu/wisconsin/joiners.py`` (``_block_bounds_perm``,
``_emit``), which XLA fuses on the TPU.  ``multijoin_probe`` takes one
worker block's rows of the split probe table (its key column and selected
column), R's payload in key order and R's key range [kmin, kmax] (each key
once), and writes each row's output at the row's own index: R's payload of
rank key - kmin and the row's selected value.  It adds each schedule
unit's matches, the block's matches and an all-unit flag into the block's
head, as ``wisconsin.joiners._dense_bounds_perm`` and ``_unit_totals``
count them.  On CUDA tensors it launches ``multijoin_probe_kernel``
(``csrc/multijoin_probe.cu``, one launch a call, counted in ``LAUNCHES``);
on CPU tensors it runs the plain version, ``multijoin_probe_ref``.  Any
other device raises; nothing falls back.
"""

from __future__ import annotations

import torch

from . import _args

LAUNCHES = 0   # blocks that ran the kernel (the plain path adds none)


def new_heads(blocks: int, units: int, device) -> torch.Tensor:
    """The heads of ``blocks`` worker blocks of ``units`` units each, as
    ``multijoin_probe`` takes them on entry: (blocks, units + 2) int64,
    every count 0 and every all-unit flag 1."""
    heads = torch.zeros((blocks, units + 2), dtype=torch.int64)
    heads[:, -1] = 1
    if device.type == "cuda":
        return heads.pin_memory().to(device, non_blocking=True)
    return heads.to(device)


def multijoin_probe_ref(keys, col, payload, kmin: int, kmax: int, start: int,
                        rows: int, ubounds, out_build, out_probe, head):
    """Rows [start, start + rows) of ``keys`` and ``col``: out_build[r] =
    payload[key - kmin] where kmin <= key <= kmax, else payload[0];
    out_probe[r] = col[r].  Adds into ``head`` (U + 2 int64, ``ubounds``
    the U + 1 unit offsets relative to start): each unit's matches, the
    block's total, and clears the all-unit flag where a row with a key >= 0
    matches nothing (a negative key is schedule padding and does not).
    Returns ``head``."""
    seg = keys[start:start + rows]
    valid = (seg >= kmin) & (seg <= kmax)
    rank = torch.where(valid, seg - kmin, 0)
    out_build[start:start + rows] = torch.index_select(payload, 0, rank)
    out_probe[start:start + rows] = col[start:start + rows]
    cum = torch.cat([valid.new_zeros((1,), dtype=torch.int64),
                     torch.cumsum(valid, 0, dtype=torch.int64)])
    ub = ubounds.clamp(0, rows)
    head[:-2] += cum[ub[1:]] - cum[ub[:-1]]
    head[-2] += cum[-1]
    head[-1] &= (valid | (seg < 0)).all().long()
    return head


def _check(keys, col, payload, kmin, kmax, start, rows, ubounds, out_build,
           out_probe, head):
    dev = _args.int32_vectors("multijoin_probe", keys=keys, col=col,
                              payload=payload, out_build=out_build,
                              out_probe=out_probe)
    for name, x in (("ubounds", ubounds), ("head", head)):
        if (not isinstance(x, torch.Tensor) or x.dtype != torch.int64
                or x.dim() != 1 or not x.is_contiguous() or x.device != dev):
            raise ValueError(f"multijoin_probe: {name} must be a contiguous "
                             f"1-D int64 tensor on {dev}")
    n = keys.numel()
    if col.numel() != n:
        raise ValueError("multijoin_probe: keys and col differ in length")
    if not (0 <= start and 0 <= rows and start + rows <= n
            and start + rows <= min(out_build.numel(), out_probe.numel())):
        raise ValueError(f"multijoin_probe: rows [{start}, {start + rows}) "
                         f"out of range")
    if head.numel() != ubounds.numel() + 1 or ubounds.numel() < 2:
        raise ValueError("multijoin_probe: head needs one entry more than "
                         "ubounds, which needs two or more")
    if not (-2**31 <= kmin <= kmax < 2**31
            and kmax - kmin < payload.numel()):
        raise ValueError(f"multijoin_probe: [{kmin}, {kmax}] is no int32 "
                         f"key range within the {payload.numel()} payload "
                         f"values")
    return dev


def multijoin_probe(keys: torch.Tensor, col: torch.Tensor,
                    payload: torch.Tensor, kmin: int, kmax: int, start: int,
                    rows: int, ubounds: torch.Tensor,
                    out_build: torch.Tensor, out_probe: torch.Tensor,
                    head: torch.Tensor) -> torch.Tensor:
    """``multijoin_probe_ref``'s outputs and head for one worker block: the
    int32 columns ``keys``, ``col``, ``payload``, ``out_build`` and
    ``out_probe``, the block's rows [start, start + rows), its units'
    offsets ``ubounds`` (int64, 0 to rows) and its ``head`` (int64,
    accumulated into, as ``new_heads`` makes it).  Returns ``head``."""
    global LAUNCHES
    dev = _check(keys, col, payload, kmin, kmax, start, rows, ubounds,
                 out_build, out_probe, head)
    if not _args.runs_kernel("multijoin_probe", dev):
        return multijoin_probe_ref(keys, col, payload, kmin, kmax, start,
                                   rows, ubounds, out_build, out_probe, head)
    _args.launch("multijoin_probe", "htm_multijoin_probe", dev,
                 keys.data_ptr(), col.data_ptr(), payload.data_ptr(),
                 payload.numel(), kmin, kmax, start, rows, ubounds.data_ptr(),
                 ubounds.numel() - 1, out_build.data_ptr(),
                 out_probe.data_ptr(), head.data_ptr())
    LAUNCHES += 1
    return head
