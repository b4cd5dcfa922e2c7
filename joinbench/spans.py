"""The port's own spans in a traced run: ``hj.*``, which the port opens
inside each join (``htm_hashjoin_tpu_torch/utils/profiler.py``, ``SPANS``)
on the clock of the card's activity.

Each idle stretch of a traced join goes to the innermost ``hj.*`` span
that covers its midpoint, as ``trace.breakdown`` gives it to the
innermost host event; a stretch no ``hj.*`` span covers goes to
``OUTSIDE``.  A program without the spans (an older commit) reads
nothing: ``idle_by_span`` returns None."""

from __future__ import annotations

from . import trace

PREFIX = "hj."
OUTSIDE = "outside hj.join"
PLANNER = frozenset({"hj.plan", "hj.sniff", "hj.line"})
ENQUEUE = frozenset({"hj.enqueue"})


def innermost(join: trace.TracedJoin, t: float):
    """The name of the shortest ``hj.*`` span of ``join`` that covers
    ``t``, or None."""
    best = None
    for name, a, b in join.host:
        if name.startswith(PREFIX) and a <= t <= b and (
                best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else None


def idle_by_span(run):
    """``{span name or OUTSIDE: idle seconds}`` summed over the traced
    joins; None without a traced join that holds a device operation and
    an ``hj.*`` span."""
    if not run.traced or not any(j.ops for j in run.traced):
        return None
    if not any(n.startswith(PREFIX) for j in run.traced for n, _, _ in
               j.host):
        return None
    out = {}
    for j in run.traced:
        for a, b in trace.idle_gaps(j):
            key = innermost(j, (a + b) / 2) or OUTSIDE
            out[key] = out.get(key, 0.0) + (b - a)
    return out


def idle_ms(run, names) -> float | None:
    """Idle milliseconds a traced join under the spans ``names``."""
    split = idle_by_span(run)
    if split is None:
        return None
    return sum(v for k, v in split.items() if k in names) / len(
        run.traced) * 1e3
