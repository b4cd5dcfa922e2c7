"""Planner: milliseconds a traced join in which the device sat idle while
the host was in the port's planner spans (``hj.plan``: route, guess, dial
and the choice after a readback; ``hj.sniff``: issuing a sniff;
``hj.line``: building the line), each idle stretch given to the innermost
``hj.*`` span over its midpoint (``spans.py``)."""

from joinbench import spans

UNIT = "ms"
LAYER = "planner"
MOVES = "join_mtuples_per_s"


def read(run):
    return spans.idle_ms(run, spans.PLANNER)
