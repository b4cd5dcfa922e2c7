"""Torch glue: milliseconds a traced join in which the device sat idle
while the host was issuing the join's device chain (the port's
``hj.enqueue`` spans: the sorts, padding, searches and kernel launches
running behind the host), each idle stretch given to the innermost
``hj.*`` span over its midpoint (``spans.py``)."""

from joinbench import spans

UNIT = "ms"
LAYER = "torch glue"
MOVES = "join_mtuples_per_s"


def read(run):
    return spans.idle_ms(run, spans.ENQUEUE)
