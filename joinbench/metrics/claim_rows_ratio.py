"""Planner: the rows handed to the scatter builds' claim step over the
build's rows: the mean over the window's joins of the line's
``claimRows`` (a counter of the port's, ``ops/insert.py``: every row of
every claim round, idle rows included) over |R|.  1 is a build that hands
each row to the claim step once; ``probeLength`` rounds over every row
read ``probeLength``."""

UNIT = "x"
LAYER = "planner"
MOVES = "join_mtuples_per_s"


def read(run):
    counts = [j.line["claimRows"] for j in run.joins
              if j.line is not None and "claimRows" in j.line]
    if not counts:
        return None
    return sum(counts) / len(counts) / run.cell.settings["r_size"]
