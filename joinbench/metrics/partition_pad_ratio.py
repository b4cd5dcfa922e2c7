"""Partitioner: the keys the multipass radix join's last pass wrote over
the keys it was given: the mean over the window's joins of the line's
``partitionedKeys`` (a counter of the port's, the pass output's length,
padding included) over |R|.  1 is a partition that writes each key once
and no padding; the padding is the passes' static sizing (every run and
every partition rounded up to whole rows, and slack rows a partition)."""

UNIT = "x"
LAYER = "partitioner"
MOVES = "join_mtuples_per_s"


def read(run):
    counts = [j.line["partitionedKeys"] for j in run.joins
              if j.line is not None and "partitionedKeys" in j.line]
    if not counts:
        return None
    return sum(counts) / len(counts) / run.cell.settings["r_size"]
