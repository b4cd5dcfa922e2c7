"""Torch glue: device milliseconds a traced join spends in operations that
are not the port's hand-written kernels (``csrc/*.cu``): elementwise ops,
sorts, searches, gathers, copies and fills."""

from joinbench import kernels, trace

UNIT = "ms"
LAYER = "torch glue"
MOVES = "join_mtuples_per_s"


def read(run):
    if not run.traced:
        return None
    known = kernels.csrc_kernels()
    glue = trace.device_seconds(
        run.traced, lambda n: trace.base_name(n) not in known)
    if not any(j.ops for j in run.traced):
        return None
    return glue / len(run.traced) * 1e3
