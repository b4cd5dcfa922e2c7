"""Partitioner: milliseconds a traced join in which the device sat idle
while the host was in the multipass partition's ``hj.passplan`` spans
(each pass's digit bounds and scatter plan between its K2 and K6, the next
pass's tile parents after an intermediate K6:
``ops.radix_kernels.multipass_radix_partition``), each idle stretch given
to the innermost ``hj.*`` span over its midpoint (``spans.py``).  A
program without the span reads nothing."""

from joinbench import spans

UNIT = "ms"
LAYER = "partitioner"
MOVES = "join_mtuples_per_s"
SPAN = "hj.passplan"


def read(run):
    if not run.traced or not any(name == SPAN for j in run.traced
                                 for name, _, _ in j.host):
        return None
    return spans.idle_ms(run, {SPAN})
