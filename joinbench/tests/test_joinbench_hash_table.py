"""The hash-table cell's readers: the build's and the probe's rooflines
(device-busy time inside the port's ``hj.build`` and ``hj.probe`` spans)
and the claim step's rows over |R|, each on made-up traced joins with
known spans and operations, each reading nothing from a program that
lacks its span or counter; the bytes they count, by hand."""

import types

import pytest

from joinbench import cells, peaks, trace
from joinbench.loop import Join

US = 1e-6


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events(port_spans=True, offset=0):
    """One join [0, 300) us.  Inside hj.build [2, 150): kernels [10, 60)
    and [40, 100) overlap (a union of 90), a copy [140, 155) is clipped to
    10; a kernel [152, 158) lies between the spans; inside hj.probe
    [160, 290): kernels [170, 200) and [200, 230), 60 in all."""
    t = offset
    events = [_x("user_annotation", trace.JOIN_SPAN, t, 300),
              _x("kernel", "index_put_kernel", t + 10, 50),
              _x("kernel", "scatter_gather_kernel", t + 40, 60),
              _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)",
                 t + 140, 15),
              _x("kernel", "reduce_kernel", t + 152, 6),
              _x("kernel", "index_kernel", t + 170, 30),
              _x("kernel", "reduce_kernel", t + 200, 30)]
    if port_spans:
        events += [_x("cpu_op", "hj.join", t + 1, 298),
                   _x("cpu_op", "hj.build", t + 2, 148),
                   _x("cpu_op", "hj.readback", t + 130, 20),
                   _x("cpu_op", "hj.probe", t + 160, 130)]
    return events


def _run(events=None, lines=(), r_size=1000, s_size=500, scale_output=2):
    cell = types.SimpleNamespace(settings=dict(
        r_size=r_size, s_size=s_size,
        cfg=types.SimpleNamespace(r_size=r_size, scale_output=scale_output)))
    joins = [Join(i, 1.0, 0.0, 0, r_size + s_size, line, None, ())
             for i, line in enumerate(lines)]
    return types.SimpleNamespace(
        cell=cell, joins=joins,
        traced=None if events is None else trace.reduce(events))


def _read(name, run):
    return cells.metric_module(name).read(run)


def test_the_bytes_of_the_cell_by_hand():
    build = cells.metric_module("hash_build_roofline")
    probe = cells.metric_module("hash_probe_roofline")
    settings = cells.load("hashjoin_2e27.shuffle").settings
    cfg, s_size = settings["cfg"], settings["s_size"]
    r, scale = cfg.r_size, cfg.scale_output
    assert (r, s_size, scale) == (1 << 27, 1 << 27, 2)
    assert build.table_slots(r, scale) == 1 << 28
    # 2^27 keys read and 2^28 slots written, 4 bytes each: 1.61 GB
    assert build.build_bytes(r, scale) == 1_610_612_736
    assert probe.probe_bytes(s_size) == 1_073_741_824
    assert build.build_bytes(r, scale) / peaks.HBM_BYTES_PER_S == \
        pytest.approx(0.4808e-3, rel=1e-3)
    # next_pow2 rounds up; a power of two stays
    assert [build.table_slots(n, 2) for n in (1, 1000, 1024, 1025)] == \
        [2, 2048, 2048, 4096]


def test_the_rooflines_read_busy_time_inside_their_spans():
    run = _run(_events() + _events(offset=1000))
    build = 100 * (4 * 1000 + 4 * 2048) / peaks.HBM_BYTES_PER_S / (100 * US)
    probe = 100 * (8 * 500) / peaks.HBM_BYTES_PER_S / (60 * US)
    assert _read("hash_build_roofline", run) == pytest.approx(build)
    assert _read("hash_probe_roofline", run) == pytest.approx(probe)
    mod = cells.metric_module("hash_build_roofline")
    assert mod.busy_in(run, "hj.build") == pytest.approx(2 * 100 * US)
    assert mod.busy_in(run, "hj.probe") == pytest.approx(2 * 60 * US)


def test_the_rooflines_read_nothing_without_their_spans_or_a_trace():
    no_ops = [e for e in _events() if e["cat"] == "cpu_op"]
    for name in ("hash_build_roofline", "hash_probe_roofline"):
        assert _read(name, _run(None)) is None
        assert _read(name, _run(_events(port_spans=False))) is None
        assert _read(name, _run(no_ops)) is None


def test_claim_rows_ratio_is_the_mean_of_the_lines_over_r():
    lines = [{"claimRows": 4000}, None, {"claimRows": 2000}]
    assert _read("claim_rows_ratio", _run(lines=lines)) == pytest.approx(3.0)
    assert _read("claim_rows_ratio", _run(lines=[{"readbacks": 4}])) is None
    assert _read("claim_rows_ratio", _run(lines=[None])) is None
