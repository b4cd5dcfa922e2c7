"""Device: the share of the traced joins' intervals in which no device
operation ran (the union of kernel, copy and fill intervals, summed over
the traced joins), in percent."""

from joinbench import trace

UNIT = "%"
LAYER = "device"
MOVES = "join_mtuples_per_s"


def read(run):
    if not run.traced or not any(j.ops for j in run.traced):
        return None
    window = sum(j.seconds for j in run.traced)
    return 100.0 * (1.0 - sum(map(trace.busy_seconds, run.traced)) / window)
