"""End to end: the joins' rate, Σ(|R| + |S|) over every join of the window
÷ Σ of their intervals, in millions of tuples a second."""

UNIT = "Mtuples/s"


def read(run):
    return sum(j.tuples for j in run.joins) / sum(
        j.seconds for j in run.joins) / 1e6
