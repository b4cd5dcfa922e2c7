"""``join_step``'s plain reference: ``reference.py``'s three numbers over
the key tensors the benchmark generated for a join (``inputs.r.keys``,
``inputs.s.keys``).  It imports nothing of the program."""

from __future__ import annotations

import torch

from joinbench import reference

FIELDS = reference.FIELDS


def expected(inputs, accumulator=torch.int64) -> dict:
    """The numbers the join's line is held to; with ``torch.int32``, the
    control."""
    return reference.expected(inputs.r.keys, inputs.s.keys,
                              accumulator=accumulator)
