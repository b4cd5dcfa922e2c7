"""The readers of the two host stretches' spans: ``schedule_idle_ms``
(``hj.schedule``, the multijoin probe's host work) and
``passplan_idle_ms`` (``hj.passplan``, the multipass partition's
planning), each the idle time a traced join whose gap's midpoint lies
innermost under its span; nothing read from a program that lacks the
span, and each listed for its one cell."""

import types

import pytest

from joinbench import cells, spans, trace
from joinbench.loop import Join

from conftest import CELLS

US = 1e-6
BENCH = cells.benchmark()
WISCONSIN = "wisconsin_independent_2e24x2e28.fk_uniform"
PRJ = "prj_2e24x2e28.fk_uniform"
READERS = {"schedule_idle_ms": ("hj.schedule", "joiner", WISCONSIN),
           "passplan_idle_ms": ("hj.passplan", "partitioner", PRJ)}


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events(t=0, port_spans=True, new_spans=True):
    """One join [t, t + 300) us: device operations at [0, 10), [40, 60),
    [100, 120), [150, 160), [200, 210) and [250, 260); so idle [10, 40),
    [60, 100), [120, 150), [160, 200), [210, 250) and [260, 300)."""
    events = [_x("user_annotation", trace.JOIN_SPAN, t, 300)]
    events += [_x("kernel", "k", t + a, b - a)
               for a, b in ((0, 10), (40, 60), (100, 120), (150, 160),
                            (200, 210), (250, 260))]
    if port_spans:
        events += [_x("user_annotation", "hj.join", t + 5, 285),
                   _x("user_annotation", "hj.probe", t + 8, 122),
                   _x("user_annotation", "hj.partition", t + 131, 109)]
    if port_spans and new_spans:
        events += [_x("user_annotation", "hj.schedule", t + 10, 35),
                   _x("user_annotation", "hj.passplan", t + 132, 6),
                   _x("user_annotation", "hj.passplan", t + 225, 10)]
    return events


# the gaps' midpoints: 25 under hj.schedule (30 us), 80 directly under
# hj.probe (40), 135 under the first hj.passplan (30), 180 directly under
# hj.partition (40), 230 under the second hj.passplan (40), 280 directly
# under hj.join (40)
WANT = {"hj.schedule": 30, "hj.probe": 40, "hj.passplan": 70,
        "hj.partition": 40, "hj.join": 40}


def _run(events=None):
    return types.SimpleNamespace(
        cell=None, joins=[Join(0, 1.0, 0.0, 0, 10, None, None, ())],
        traced=None if events is None else trace.reduce(events))


def _read(name, run):
    return cells.metric_module(name).read(run)


def test_the_gaps_split_by_span():
    split = spans.idle_by_span(_run(_events()))
    assert split == pytest.approx({k: v * US for k, v in WANT.items()})


@pytest.mark.parametrize("name", list(READERS))
def test_each_reads_only_the_idle_under_its_span(name):
    span = READERS[name][0]
    assert _read(name, _run(_events())) == pytest.approx(WANT[span] * US
                                                         * 1e3)
    # a second traced join idling 300 us under nothing but its own span
    second = [_x("user_annotation", trace.JOIN_SPAN, 1000, 300),
              _x("kernel", "k", 1000, 1),
              _x("user_annotation", "hj.join", 1000, 300),
              _x("user_annotation", span, 1001, 299)]
    assert _read(name, _run(_events() + second)) == pytest.approx(
        (WANT[span] + 299) * US * 1e3 / 2)


@pytest.mark.parametrize("name", list(READERS))
def test_each_reads_nothing_without_its_span_or_a_trace(name):
    assert _read(name, _run(None)) is None
    assert _read(name, _run(_events(port_spans=False))) is None
    # the port's other spans, as a program before these two has them
    assert _read(name, _run(_events(new_spans=False))) is None
    no_ops = [e for e in _events() if e["cat"] == "user_annotation"]
    assert _read(name, _run(no_ops)) is None


@pytest.mark.parametrize("name", list(READERS))
def test_each_is_listed_for_its_cell_alone(name):
    span, layer, cell = READERS[name]
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert entry == {"name": name, "unit": "ms", "better": "lower",
                     "source": "device_trace", "layer": layer,
                     "moves": "join_mtuples_per_s", "workloads": [cell]}
    assert cells.metric_module(name).SPAN == span
    for other in CELLS:
        names = {m["name"] for m in cells.load(other).per_layer}
        assert (name in names) == (other == cell)
