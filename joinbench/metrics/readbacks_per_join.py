"""Planner: the host's waits on the device a join (copies to the host and
synchronizes), the mean over the window's joins of the line's
``readbacks``, a counter of the port's (``utils/timing.py``)."""

UNIT = "count"
LAYER = "planner"
MOVES = "join_ms_p95"


def read(run):
    counts = [j.line["readbacks"] for j in run.joins
              if j.line is not None and "readbacks" in j.line]
    if not counts:
        return None
    return sum(counts) / len(counts)
