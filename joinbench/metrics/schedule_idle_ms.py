"""Joiner: milliseconds a traced join in which the device sat idle while
the host was in the multijoin probe's ``hj.schedule`` spans (the schedule,
the checks, uploads and allocations before the first worker block, the
measured schedule after the heads' readback, the per-partition costs:
``wisconsin.joiners.HashJoiner``), each idle stretch given to the
innermost ``hj.*`` span over its midpoint (``spans.py``).  A program
without the span reads nothing."""

from joinbench import spans

UNIT = "ms"
LAYER = "joiner"
MOVES = "join_mtuples_per_s"
SPAN = "hj.schedule"


def read(run):
    if not run.traced or not any(name == SPAN for j in run.traced
                                 for name, _, _ in j.host):
        return None
    return spans.idle_ms(run, {SPAN})
