"""What the kernel roofline readers (``metrics/k*_roofline.py``) share: the
device time of the kernels a reader counts, and a word on standard error
for each kernel of the same source that it does not count."""

from __future__ import annotations

import sys

from . import kernels, trace


def seconds(run, source: str, counted: set, metric: str, accept) -> float:
    """Device seconds over the traced joins of the kernels of ``source``
    named in ``counted`` whose full name ``accept`` takes; 0 without a
    trace."""
    if not run.traced:
        return 0.0
    of_source = {k for k, src in kernels.csrc_kernels().items()
                 if src == source}
    total, skipped = 0.0, {}
    for j in run.traced:
        for name, a, b in j.ops:
            base = trace.base_name(name)
            if base not in of_source:
                continue
            if base in counted and accept(name):
                total += b - a
            else:
                key = trace.short_name(name)
                skipped[key] = skipped.get(key, 0.0) + (b - a)
    for key, sec in skipped.items():
        print(f"joinbench: {metric} does not count {key} of {source} "
              f"({sec} s over the traced joins)", file=sys.stderr)
    return total
