"""Planner: the keys the plan gave K3, the global sort, over the keys the
join needs sorted: the mean over the window's joins of the line's
``sortedKeys`` (a counter of the port's, ``ops/global_sort.py``, padding
included) over R's keys, plus S's where S is not handed sorted
(``k3_roofline.keys_sorted``).  1 is a plan that sorts each input once."""

from joinbench import cells

UNIT = "x"
LAYER = "planner"
MOVES = "join_mtuples_per_s"


def read(run):
    counts = [j.line["sortedKeys"] for j in run.joins
              if j.line is not None and "sortedKeys" in j.line]
    if not counts:
        return None
    settings = run.cell.settings
    need = cells.metric_module("k3_roofline").keys_sorted(
        settings["r_size"], settings["s_size"], settings["s_gen"].SORTED)
    return sum(counts) / len(counts) / need
