"""The readers of the port's own spans and counters: idle time given to the
innermost ``hj.*`` span over each gap's midpoint, the line's readbacks and
sorted keys, and nothing read from a program that lacks them."""

import types

import pytest

from joinbench import cells, spans, trace
from joinbench.loop import Join

US = 1e-6


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events(port_spans=True):
    """One join [0, 200) us: kernels at [1, 2), [15, 60), [110, 120) and
    [130, 140); so idle [0, 1), [2, 15), [60, 110), [120, 130) and
    [140, 200)."""
    events = [_x("user_annotation", trace.JOIN_SPAN, 0, 200),
              _x("kernel", "radix_histogram", 1, 1),
              _x("kernel", "radix_scatter<false>", 15, 45),
              _x("kernel", "banded_count_kernel<512, 3>", 110, 10),
              _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 130, 10),
              _x("cpu_op", "aten::cat", 100, 30)]
    if port_spans:
        events += [_x("user_annotation", "hj.join", 2, 196),
                   _x("user_annotation", "hj.sniff", 2, 18),
                   _x("user_annotation", "hj.readback", 50, 30),
                   _x("user_annotation", "hj.plan", 80, 20),
                   _x("user_annotation", "hj.enqueue", 100, 30),
                   _x("user_annotation", "hj.readback", 130, 15),
                   _x("user_annotation", "hj.line", 150, 46)]
    return events


def _run(events=None, lines=(), r_size=100, s_size=50, s_sorted=True):
    cell = types.SimpleNamespace(settings=dict(
        r_size=r_size, s_size=s_size,
        s_gen=types.SimpleNamespace(SORTED=s_sorted)))
    joins = [Join(i, 1.0, 0.0, 0, 10, line, None, ())
             for i, line in enumerate(lines)]
    return types.SimpleNamespace(
        cell=cell, joins=joins,
        traced=None if events is None else trace.reduce(events))


def _read(name, run):
    return cells.metric_module(name).read(run)


def test_each_gap_goes_to_the_innermost_span_over_its_midpoint():
    split = spans.idle_by_span(_run(_events()))
    want = {spans.OUTSIDE: 1,        # [0, 1): before hj.join opens
            "hj.sniff": 13,          # [2, 15): hj.sniff inside hj.join
            "hj.plan": 50,           # [60, 110): midpoint 85
            "hj.enqueue": 10,        # [120, 130): midpoint 125, not hj.join
            "hj.line": 60}           # [140, 200): midpoint 170
    assert split == pytest.approx({k: v * US for k, v in want.items()})
    joined = trace.reduce(_events())[0]
    assert sum(split.values()) == pytest.approx(
        sum(b - a for a, b in trace.idle_gaps(joined)))


def test_planner_and_enqueue_idle_ms_per_traced_join():
    events = _events() + [_x("user_annotation", trace.JOIN_SPAN, 300, 100),
                          _x("kernel", "radix_histogram", 300, 90),
                          _x("user_annotation", "hj.join", 300, 100),
                          _x("user_annotation", "hj.plan", 385, 15)]
    run = _run(events)
    # the second join idles [390, 400), under hj.plan: two traced joins
    assert _read("planner_idle_ms", run) == pytest.approx(
        (13 + 50 + 60 + 10) * US / 2 * 1e3)
    assert _read("enqueue_idle_ms", run) == pytest.approx(10 * US / 2 * 1e3)


def test_idle_readers_find_nothing_without_the_ports_spans_or_a_trace():
    for name in ("planner_idle_ms", "enqueue_idle_ms"):
        assert _read(name, _run(None)) is None
        assert _read(name, _run(_events(port_spans=False))) is None
        no_ops = [e for e in _events() if e["cat"] == "user_annotation"]
        assert _read(name, _run(no_ops)) is None
    assert spans.idle_by_span(_run(_events(port_spans=False))) is None


def test_readbacks_per_join_is_the_mean_of_the_lines():
    lines = [{"readbacks": 3}, {"readbacks": 4}, None, {"readbacks": 3}]
    assert _read("readbacks_per_join", _run(lines=lines)) == \
        pytest.approx(10 / 3)
    assert _read("readbacks_per_join", _run(lines=[{"totalMatches": 1}])) \
        is None
    assert _read("readbacks_per_join", _run(lines=[None])) is None


@pytest.mark.parametrize("s_sorted,need", [(True, 100), (False, 150)])
def test_sorted_keys_ratio_over_the_keys_the_join_needs_sorted(s_sorted,
                                                               need):
    lines = [{"sortedKeys": 128}, {"sortedKeys": 384}]
    run = _run(lines=lines, s_sorted=s_sorted)
    assert _read("sorted_keys_ratio", run) == pytest.approx(256 / need)
    assert _read("sorted_keys_ratio", _run(lines=[{"readbacks": 1}])) \
        is None
