"""The benchmark's Wisconsin multijoin cell
(``wisconsin_independent_2e24x2e28.fk_uniform``: the multijoin's own
driver, ``wisconsin.driver.join_tables``, on the independent conf) on the
CPU at its configuration's ``small_argv`` (2^16 ⋈ 2^20), held exactly to
the entry's plain reference (``joinbench/entries/multijoin_reference.py``)
on the cell's conf and on ``no_partition.conf``, on the cell's traffic and
on an R whose keys repeat.  Then the benchmark's own loop on the cell:
correct, and not correct under each planted fault and the control; and
the cell's three readers (``split_roofline``, ``k7_roofline``,
``multijoin_probe_roofline``) on made-up traced joins."""

import json
import os
import time
import types

import pytest
import torch

from joinbench import cells, control, loop, report
from htm_hashjoin_tpu_torch.wisconsin import CONF_DIR, parse_conf
from htm_hashjoin_tpu_torch.wisconsin import driver
from htm_hashjoin_tpu_torch.wisconsin.joiners import HashJoiner
from htm_hashjoin_tpu_torch.wisconsin.schema import Schema
from htm_hashjoin_tpu_torch.wisconsin.table import Table

CPU = torch.device("cpu")
NAME = "wisconsin_independent_2e24x2e28.fk_uniform"
SEEDS = [2**31 + 41, 2**32 + 7, 3]
CONFS = ["independent", "no_partition"]


def cell(conf="independent"):
    """The cell at its ``small_argv``, on ``conf`` cut to the same
    sizes."""
    config = cells.config_file("wisconsin_independent_2e24x2e28")
    c = cells.load(NAME, config["small_argv"])
    if conf != "independent":
        s = c.settings
        c.settings = dict(s, conf=c.entry.shrink(
            parse_conf(os.path.join(CONF_DIR, f"{conf}.conf")),
            s["r_size"], s["s_size"]))
    return c


def checked(c, inputs):
    """The reference's numbers, then the line of ``join_tables`` on the
    same tables (which frees their columns)."""
    want = c.reference.expected(inputs)
    return want, c.entry.join(c, inputs)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("conf", CONFS)
def test_join_tables_equals_the_reference(conf, seed):
    c = cell(conf)
    inputs = c.entry.make(c, c.entry.prepare(c, seed, CPU), 0, CPU)
    want, line = checked(c, inputs)
    assert {f: line[f] for f in c.reference.FIELDS} == want
    assert line["outputRows"] == c.settings["s_size"] == line["probeRows"]
    assert set(line) >= driver.PORT_ONLY_FIELDS
    assert line["readbacks"] > 0


@pytest.mark.parametrize("conf", CONFS)
def test_repeated_build_keys_fan_out(conf):
    """R of 2^16 rows over 2^14 keys (about four rows a key), S of 2^18
    rows over 2^16 keys, of which a quarter find no R row."""
    c = cell(conf)
    g = torch.Generator().manual_seed(SEEDS[0])
    r = torch.randint(1, 1 << 14, (1 << 16,), generator=g,
                      dtype=torch.int32)
    s = torch.randint(1, 1 << 16, (1 << 18,), generator=g,
                      dtype=torch.int32)
    confd = c.settings["conf"]
    schema = Schema.create(("long", "long"))

    def table(keys, side):
        rows = torch.arange(1, keys.numel() + 1, dtype=torch.int32)
        return Table(schema, [keys, rows], driver.page_size(confd, side))
    entry = c.entry
    inputs = entry.Tables(table(r, "build"), table(s, "probe"), 0, ())
    want, line = checked(c, inputs)
    assert {f: line[f] for f in c.reference.FIELDS} == want
    counts = torch.bincount(r.long(), minlength=1 << 16)
    assert want["outputRows"] == int(counts[s.long()].sum())
    assert want["outputRows"] > s.numel()      # matches fan out


def test_the_cells_loop_on_the_cpu_is_correct():
    run = loop.run(cell(), SEEDS[0], 0.05, False, "cpu", time.perf_counter())
    out = report.result(run, False)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["check"]) == {f"{f}_gap" for f in run.cell.reference.FIELDS}
    assert all(v["value"] == 0 and v["limit"] == 0
               for v in out["check"].values())
    # on the CPU: each split's and the build's fence, the splits' sizes,
    # the build's key statistics and certificate, the probe's heads and
    # fence, the line's sums
    assert all(j.line["readbacks"] == 10 for j in run.joins)


def _emit_edit(edit):
    """``join_tables`` with ``edit`` applied to the output where the joiner
    materialises it."""
    def join(c, inputs):
        real = HashJoiner._emit

        def emit(self, *args, **kwargs):
            out = real(self, *args, **kwargs)
            edit(out)
            return out
        HashJoiner._emit = emit
        try:
            return c.entry.join(c, inputs)
        finally:
            HashJoiner._emit = real
    return join


def _drop_a_row(out):
    out.rows -= 1


def _swap_probe_rows(out):
    # two rows whose build payloads differ: counts and sums stay, the
    # pairing does not
    col = out.columns[1]
    col[[0, 1]] = col[[1, 0]].clone()


def _lose_a_build_row(c, inputs):
    b = inputs.build
    inputs.build = Table(b.schema, [col[1:] for col in b.columns],
                         b.page_size)
    return c.entry.join(c, inputs)


def _raise(c, inputs):
    raise RuntimeError("planted fault")


FAULTS = {
    "an output row dropped": (_emit_edit(_drop_a_row), None),
    "two rows' probe payloads swapped": (_emit_edit(_swap_probe_rows),
                                         "outputPairSum_gap"),
    "a build row lost": (_lose_a_build_row, None),
    "the join raises": (_raise, None),
    "the control": (control.control_join, None),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_makes_the_run_not_correct(fault):
    join_fn, only = FAULTS[fault]
    run = loop.run(cell(), SEEDS[1], 0.05, False, "cpu", time.perf_counter(),
                   join_fn=join_fn)
    assert not report.correct(run) and run.failed >= 1
    if only:
        assert {k for k, v in run.check.items() if v} == {only}


def test_run_multijoin_gives_join_tables_line_on_its_tables():
    c = cell()
    conf = c.settings["conf"]
    res = driver.run_multijoin(conf, device=CPU)
    tables = driver.load_tables(conf, ".", CPU)
    again = driver.join_tables(conf, *tables)

    def fixed(r):
        line = r.to_dict()
        sched = line.pop("probeSchedule")
        return ({k: v for k, v in line.items() if not k.endswith("TimeNs")},
                {k: sched[k] for k in ("policy", "route", "units")})
    assert fixed(res) == fixed(again)
    assert json.loads(res.to_json_line()) == res.to_dict()
    assert list(res.timings_ns) == ["generate", "split_build", "split_probe",
                                    "build", "probe"]
    for i in (1, 2):
        assert torch.equal(res.output.column(i), again.output.column(i))


def test_output_sums_wrap_at_64_bits_in_blocks(monkeypatch):
    """Values near 2^31 in both columns: the products' sum passes 2^64
    and wraps as Python's modular sum does; a string column is left out;
    blocks of 3 rows give the whole's sums; rows past ``rows`` are not
    read."""
    import numpy as np
    n = 1000
    b = torch.full((n + 5,), 2**31 - 1, dtype=torch.int32)
    p = torch.arange(2**31 - n - 5, 2**31, dtype=torch.int32)
    names = np.array([str(i) for i in range(n + 5)], dtype=object)
    out = Table(Schema.create(("long", "string", "long")), [b, names, p],
                rows=n)

    def wrap(x):
        return (x + 2**63) % 2**64 - 2**63
    bl, pl = [2**31 - 1] * n, p[:n].tolist()
    want = [wrap(sum(bl)), wrap(sum(pl)),
            wrap(sum(x * y for x, y in zip(bl, pl)))]
    assert driver.output_sums(out, 2).tolist() == want
    monkeypatch.setattr(driver, "SUM_BLOCK", 3)
    assert driver.output_sums(out, 2).tolist() == want
    assert want[2] != sum(x * y for x, y in zip(bl, pl))   # it wrapped


def test_the_entry_checks_its_conf_and_traffic(tmp_path):
    config = cells.config_file("wisconsin_independent_2e24x2e28")
    traffic = cells.traffic_file("fk_uniform")
    entry = cells.entry_module("multijoin")
    settings = entry.load(config, traffic)
    assert (settings["r_size"], settings["s_size"]) == (1 << 24, 1 << 28)
    with pytest.raises(ValueError, match="configuration file"):
        entry.load(dict(config, r_size=1 << 23), traffic)
    with pytest.raises(ValueError, match="argv"):
        entry.load(config, dict(traffic, argv=["--dataDistr", "fk"]))
    text = open(os.path.join(CONF_DIR, "independent.conf")).read()
    other = tmp_path / "other.conf"          # the key selected too
    other.write_text(text.replace("select:\t(2);", "select:\t(1, 2);"))
    assert other.read_text() != text
    with pytest.raises(ValueError, match="row id"):
        entry.load(dict(config, conf=str(other)), traffic)
    small = entry.load(config, traffic, config["small_argv"])
    conf = small["conf"]
    assert (small["r_size"], small["s_size"]) == (1 << 16, 1 << 20)
    assert conf["partitioner"]["hash"]["range"] == [1, 1 << 16]
    assert conf["partitioner"]["hash"]["skipbits"] == 17 - 8


US = 1e-6


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _traced_run(port_spans=True, output_rows=500):
    """Two made-up traced joins of [0, 300) us, 1000 R rows and 500 S
    rows.  Inside hj.split [2, 100): K7's histogram [5, 8) and scatter
    [10, 40), glue [40, 90) and a K3 scatter [60, 70) (83 busy, 33 of
    K7); a K7 scatter [110, 120) between the spans; inside hj.probe
    [150, 290): kernels [160, 200) (40 busy).  The window's first join is
    not traced, as in a run."""
    from joinbench import trace
    from joinbench.loop import Join
    events = []
    for t in (0, 1000):
        events += [_x("user_annotation", trace.JOIN_SPAN, t, 300),
                   _x("kernel", "radix_histogram", t + 5, 3),
                   _x("kernel", "void radix_scatter<true>(int const*, int)",
                      t + 10, 30),
                   _x("kernel", "at::native::elementwise_kernel<4>", t + 40,
                      50),
                   _x("kernel", "void radix_scatter<false>(int const*)",
                      t + 60, 10),
                   _x("kernel", "void radix_scatter<true>(int const*, int)",
                      t + 110, 10),
                   _x("kernel", "at::native::index_kernel", t + 160, 40)]
        if port_spans:
            events += [_x("cpu_op", "hj.join", t + 1, 298),
                       _x("cpu_op", "hj.split", t + 2, 98),
                       _x("cpu_op", "hj.probe", t + 150, 140)]
    lines = [None] + [{"outputRows": output_rows}] * 2
    joins = [Join(i, 1.0, 0.0, 0, 1500, line, None, ())
             for i, line in enumerate(lines)]
    return types.SimpleNamespace(
        cell=types.SimpleNamespace(settings=dict(r_size=1000, s_size=500)),
        joins=joins, traced=trace.reduce(events))


def test_the_multijoin_readers_on_made_up_traced_joins():
    from joinbench import peaks
    run = _traced_run()

    def read(name, r=run):
        return cells.metric_module(name).read(r)
    split = 100 * 2 * 16 * 1500 / peaks.HBM_BYTES_PER_S / (2 * 83 * US)
    k7 = 100 * 2 * 16 * 1500 / peaks.HBM_BYTES_PER_S / (2 * 33 * US)
    probe = (100 * 2 * (4 * 500 + 8 * 1000 + 8 * 500)
             / peaks.HBM_BYTES_PER_S / (2 * 40 * US))
    assert read("split_roofline") == pytest.approx(split)
    assert read("k7_roofline") == pytest.approx(k7)
    assert read("multijoin_probe_roofline") == pytest.approx(probe)
    more = _traced_run(output_rows=700)
    assert read("multijoin_probe_roofline", more) == pytest.approx(
        probe * (4 * 500 + 8 * 1000 + 8 * 700) / (4 * 500 + 8 * 1000
                                                 + 8 * 500))
    # a program without the spans, or a run without a trace, reads nothing
    bare = _traced_run(port_spans=False)
    untraced = types.SimpleNamespace(cell=run.cell, joins=run.joins,
                                     traced=None)
    for name in ("split_roofline", "k7_roofline",
                 "multijoin_probe_roofline"):
        assert read(name, bare) is None and read(name, untraced) is None
    run.joins[1].line = None                  # a traced join that failed
    assert read("multijoin_probe_roofline") is None
