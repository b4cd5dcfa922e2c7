"""Planner: the share of the window's joins whose first plan was abandoned,
from the fields of each join's line (a counter of the program's):

* ``resorted``: the optimistic sort aborted and was rerun exactly, or the
  dial's guess aborted and the join was replanned (the adaptive paths);
* ``failedTransactions`` > 0: the optimistic sorter's violations;
* ``conflictCount`` > 0: tiles the count flagged and the repair recounted
  (the banded engine's lines);
* ``totalOverflows`` > 0: overflow, where a path prints it."""

UNIT = "%"
LAYER = "planner"
MOVES = "join_ms_p95"


def replanned(line: dict) -> bool:
    return bool(line.get("resorted")) or any(
        (line.get(k) or 0) > 0 for k in ("failedTransactions",
                                         "conflictCount", "totalOverflows"))


def read(run):
    lines = [j.line for j in run.joins if j.line is not None]
    if not lines:
        return None
    return 100.0 * sum(map(replanned, lines)) / len(lines)
