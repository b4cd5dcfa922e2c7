"""The port's spans (``hj.*``, ``utils/profiler.span``) and its three
per-join counters (``readbacks``, ``sortedKeys``, ``claimRows``) on the CPU,
with the kernels' plain versions, on the paths of the benchmark's four cells
at a small size (``joinbench.cells.load`` with smaller sizes, as
``joinbench/tests`` runs them), on the two skew paths, which the small zipf
cell does not reach: R 2^17 keys (16 tiles) and S 2^20 keys piled on R's
first six tiles, which flag, over max(4, F/8): the mass path recounts them
in place with K4; or on its first two: the batched repair recounts them;
and on the four scatter-build joins (nocc, atomic, npo, htm's scatter
route), whose build and probe are the ``hj.build`` and ``hj.probe``
spans."""

import gzip
import glob
import json

import pytest
import torch

from joinbench import cells, loop
from htm_hashjoin_tpu_torch import cli
from htm_hashjoin_tpu_torch.joins import (DISPATCH, adaptive, banded_backend,
                                          htm, npo)
from htm_hashjoin_tpu_torch.joins.banded_backend import DEFAULT_TILE
from htm_hashjoin_tpu_torch.ops import global_sort, insert
from htm_hashjoin_tpu_torch.relation import Relation
from htm_hashjoin_tpu_torch.utils import profiler, timing
from htm_hashjoin_tpu_torch.utils.metrics import PORT_ONLY_FIELDS, JoinMetrics

CPU = torch.device("cpu")
SEED = 2**31 + 7
SMALL = {"adaptive_2e27": ["--rSize", str(1 << 17)],
         "pro_2e24x2e28": ["-r", str(1 << 17), "-s", str(1 << 19)],
         "hashjoin_2e27": ["--rSize", str(1 << 17)]}
R, S = 1 << 17, 1 << 19
PILED_S = 1 << 20
# (cell, readbacks, sortedKeys, R's tiles S is piled on) of each path
CASES = {
    # the build's fence and the spill's readback, the probe's fence and
    # its readback; no K3 (the claim rounds: claimRows, below)
    "atomic": ("hashjoin_2e27.shuffle", 4, 0, None),
    # K3 sorts S and R, K4 counts, one readback
    "fk_uniform": ("pro_2e24x2e28.fk_uniform", 1, R + S, None),
    # the sniff's readback, the fused dial's (the guess aborts), the
    # sort-first replan's fence; K3 sorts R
    "shuffle": ("adaptive_2e27.shuffle", 3, R, None),
    # at this size no tile flags: as fk_uniform
    "fk_zipf1": ("pro_2e24x2e28.fk_zipf1", 1, R + S, None),
    # the fence, then the in-place recount's readback; K3 sorts no more
    # than R and S
    "mass": ("pro_2e24x2e28.fk_zipf1", 2, R + PILED_S, 6),
    # the fence, then the repair's readback; K3 also sorts the two
    # flagged tiles
    "repair": ("pro_2e24x2e28.fk_zipf1", 2, R + PILED_S + 2 * (1 << 13), 2),
}


# each case's hj.* spans in the order entered, as (name, nesting depth),
# for one join (the test runs two): which span is innermost over each op
# and host step is what the planner and enqueue metrics read on the card
_ENGINE = [("hj.join", 0), ("hj.plan", 1), ("hj.plan", 1),
           ("hj.enqueue", 2), ("hj.readback", 2), ("hj.plan", 2)]
SPAN_SEQUENCES = {
    "atomic": [("hj.join", 0), ("hj.build", 1), ("hj.readback", 2),
               ("hj.readback", 2), ("hj.probe", 1), ("hj.readback", 2),
               ("hj.readback", 2), ("hj.line", 1)],
    "fk_uniform": _ENGINE + [("hj.line", 2), ("hj.line", 3)],
    "shuffle": [("hj.join", 0), ("hj.sniff", 1), ("hj.readback", 1),
                ("hj.plan", 1), ("hj.plan", 2), ("hj.sniff", 2),
                ("hj.plan", 2), ("hj.enqueue", 2), ("hj.readback", 2),
                ("hj.plan", 2), ("hj.plan", 2), ("hj.enqueue", 3),
                ("hj.readback", 3), ("hj.plan", 3), ("hj.line", 2),
                ("hj.line", 3), ("hj.line", 2)],
    "fk_zipf1": _ENGINE + [("hj.line", 2), ("hj.line", 3)],
    "mass": _ENGINE + [("hj.recount", 2), ("hj.enqueue", 3),
                       ("hj.enqueue", 3), ("hj.readback", 3),
                       ("hj.line", 2), ("hj.line", 3)],
    "repair": _ENGINE + [("hj.repair", 2), ("hj.enqueue", 3),
                         ("hj.enqueue", 3), ("hj.enqueue", 3),
                         ("hj.readback", 3), ("hj.line", 2), ("hj.line", 3)],
}


def join_case(name, index=0):
    """(join step, r, s, cfg) of a case, the relations of join ``index``:
    fresh ones for each join, as the benchmark makes them (the dial keeps
    the plan of a relation it has seen)."""
    cell_name = CASES[name][0]
    cell = cells.load(cell_name, SMALL[cell_name.split(".")[0]])
    r, s = loop.Inputs(cell, SEED, CPU).pair(index)
    piled = CASES[name][3]
    if piled:
        g = torch.Generator().manual_seed(SEED + index)
        s = Relation(torch.randint(1, piled * DEFAULT_TILE + 1, (PILED_S,),
                                   generator=g, dtype=torch.int32))
    return DISPATCH[cell.cfg.algo.value], r, s, cell.cfg


class CountingRecordFunction:
    entered = 0

    def __init__(self, name, args=None):
        self.name = name

    def __enter__(self):
        CountingRecordFunction.entered += 1
        return self

    def __exit__(self, *exc):
        return False


def hj_events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("name", "").startswith("hj.")]


def inside(ev, outer, eps=0.01):
    return (ev["ts"] >= outer["ts"] - eps
            and ev["ts"] + ev["dur"] <= outer["ts"] + outer["dur"] + eps)


def span_sequence(events):
    """(name, depth) of each span in the order entered, depth being the
    number of spans around it."""
    events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    return [(e["name"], sum(inside(e, o) for o in events if o is not e))
            for e in events]


def test_a_span_without_a_profiler_is_one_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiler.span("hj.plan") is profiler.span("hj.line")
    with profiler.span("hj.plan") as entered:
        assert entered is None


@pytest.mark.parametrize("name", list(CASES))
def test_no_profiler_no_record_function(name, monkeypatch):
    fn, r, s, cfg = join_case(name)
    monkeypatch.setattr(torch.profiler, "record_function",
                        CountingRecordFunction)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        CountingRecordFunction)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        CountingRecordFunction, raising=False)
    CountingRecordFunction.entered = 0
    line = fn(r, s, cfg).to_dict()
    assert CountingRecordFunction.entered == 0
    assert PORT_ONLY_FIELDS <= set(line)


@pytest.mark.parametrize("name", list(CASES))
def test_spans_nest_in_one_join_span_and_readbacks_match(name, tmp_path):
    cases = [join_case(name, i) for i in range(2)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        metrics = [fn(r, s, cfg) for fn, r, s, cfg in cases]
    lines = [m.to_dict() for m in metrics]
    events = hj_events(prof, tmp_path)
    assert span_sequence(events) == SPAN_SEQUENCES[name] * 2
    joins = sorted((e for e in events if e["name"] == "hj.join"),
                   key=lambda e: e["ts"])
    assert len(joins) == len(lines) == 2
    assert {e["name"] for e in events} <= set(profiler.SPANS)
    path = ({"hj.build", "hj.probe"} if name == "atomic"
            else {"hj.enqueue", "hj.plan"})
    assert {"hj.readback", "hj.line"} | path <= {e["name"] for e in events}
    for e in events:
        assert sum(inside(e, j) for j in joins) == 1, e
    for j, line in zip(joins, lines):
        readbacks = [e for e in events
                     if e["name"] == "hj.readback" and inside(e, j)]
        assert len(readbacks) == line["readbacks"] == CASES[name][1]
    if CASES[name][3]:
        assert all(line["conflictCount"] == CASES[name][3]
                   for line in lines)
        assert {"hj.recount" if name == "mass" else "hj.repair"} <= \
            {e["name"] for e in events}
    if name == "shuffle":
        assert {"hj.sniff"} <= {e["name"] for e in events}


@pytest.mark.parametrize("name", list(CASES))
def test_sorted_keys_are_the_keys_given_to_k3(name, monkeypatch):
    fn, r, s, cfg = join_case(name)
    given = []
    plain = global_sort.global_sort_ref

    def recorded(keys):
        given.append(keys.numel())
        return plain(keys)

    monkeypatch.setattr(global_sort, "global_sort_ref", recorded)
    before = global_sort.SORTED_KEYS
    line = fn(r, s, cfg).to_dict()
    assert line["sortedKeys"] == sum(given) == CASES[name][2]
    assert global_sort.SORTED_KEYS - before == sum(given)
    assert line["totalMatches"] == int(
        (torch.searchsorted(torch.sort(r.keys).values, s.keys, right=True)
         - torch.searchsorted(torch.sort(r.keys).values, s.keys)).sum())


def test_the_mass_recount_is_one_more_k4_count_in_hj_recount(tmp_path,
                                                            monkeypatch):
    """The mass case's trace: K4 counts twice, the second time inside
    ``hj.recount``, which holds no K3 sort."""
    fn, r, s, cfg = join_case("mass")
    real = banded_backend.banded_count

    def k4(*args, **kwargs):
        with torch.profiler.record_function("k4"):
            return real(*args, **kwargs)

    monkeypatch.setattr(banded_backend, "banded_count", k4)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn(r, s, cfg)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    (recount,) = [e for e in events if e["name"] == "hj.recount"]
    counts = sorted((e for e in events if e["name"] == "k4"),
                    key=lambda e: e["ts"])
    assert [inside(e, recount) for e in counts] == [False, True]
    sorts = [e for e in events if e["name"] == "aten::sort"]
    assert sorts and not any(inside(e, recount) for e in sorts)


def test_the_adaptive_join_is_one_scope(tmp_path):
    """adaptive_join calls htm_join, itself a DISPATCH entry: one hj.join,
    and counters counted once; htm_join alone has its own scope, with one
    readback (the sniff's) fewer."""
    fn, r, s, cfg = join_case("shuffle")
    _, r1, s1, _ = join_case("shuffle", 1)
    assert fn is adaptive.adaptive_join
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        outer = adaptive.adaptive_join(r, s, cfg)
        inner = htm.htm_join(r1, s1, cfg)
    outer, inner = outer.to_dict(), inner.to_dict()
    joins = [e for e in hj_events(prof, tmp_path) if e["name"] == "hj.join"]
    assert len(joins) == 2
    assert outer["chosenPath"] == "htm" and outer["resorted"]
    assert (outer["readbacks"], outer["sortedKeys"]) == (3, R)
    assert (inner["readbacks"], inner["sortedKeys"]) == (2, R)


def test_a_join_that_raises_leaves_no_scope_open():
    fn, r, s, cfg = join_case("fk_uniform")
    with pytest.raises(AttributeError):
        fn(None, s, cfg)
    assert fn(r, s, cfg).to_dict()["readbacks"] == 1


def test_fences_and_readbacks_count_one_wait_each():
    before = timing.READBACKS
    x = torch.arange(4)
    assert timing.fence_outputs((x, [x + 1])) is not None
    assert timing.fence_outputs(None) is None
    assert timing.readback(x) == [0, 1, 2, 3]
    assert timing.readback(x.sum()) == 6
    assert timing.READBACKS - before == 3


def test_cli_profile_trace_holds_the_ports_spans(tmp_path, capsys):
    argv = ["--algo", "adaptive", "--adaptive", "--rSize", str(1 << 15),
            "--dataDistr", "shuffle", "--profile", str(tmp_path / "prof")]
    assert cli.main(argv, device=CPU) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["readbacks"] == 3 and line["sortedKeys"] == 1 << 15
    (path,) = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json*"))
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("hj.join") == 1
    assert names.count("hj.readback") == 3


@pytest.mark.parametrize("fast", [True, False])
def test_a_span_while_recording_is_a_named_event(fast, monkeypatch,
                                                 tmp_path):
    """torch's C++ record function where torch has it, else the class;
    either gives one named event in the trace."""
    if not fast:
        monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast",
                            raising=False)
    m = JoinMetrics(algo="htm", rSize=4)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiler.span("hj.plan"):
            torch.ones(3).sum()
        m.to_dict()                     # the line's dict is an hj.line
    assert [e["name"] for e in hj_events(prof, tmp_path)] == ["hj.plan",
                                                             "hj.line"]


# the scatter-build joins at |R| = |S| = 2^14 (R shuffled, S sorted: the
# hash cell's traffic), and the rows each hands to the claim step per R
# row: probeLength rounds (atomic, nocc), npo's BUCKET_SIZE rounds, htm's
# optimistic scatter and three retry rounds (one without retry)
SCATTER_R = 1 << 14
SCATTER = {
    "atomic": (["--algo", "atomic"], 4),
    "nocc": (["--algo", "nocc"], 4),
    "npo": (["--algo", "npo"], npo.BUCKET_SIZE),
    "npo_st": (["--algo", "npo_st"], npo.BUCKET_SIZE),
    "htm": (["--algo", "htm"], 1 + 3),
    "htm_noretry": (["--algo", "htm", "--noRetry"], 1),
}


def scatter_case(name, index=0):
    cell = cells.load("hashjoin_2e27.shuffle", [
        "--rSize", str(SCATTER_R), *SCATTER[name][0]])
    assert cell.cfg.backend == "xla" and cell.cfg.probe_length == 4
    r, s = loop.Inputs(cell, SEED, CPU).pair(index)
    return DISPATCH[cell.cfg.algo.value], r, s, cell.cfg


@pytest.mark.parametrize("name", ["nocc", "atomic", "npo", "htm"])
def test_scatter_joins_build_and_probe_in_their_own_spans(name, tmp_path):
    """hj.build and hj.probe once each, one after the other inside
    hj.join, and every readback of the join inside one of them (the
    build's fence and the spill's readback; the probe's fence and its
    readback)."""
    fn, r, s, cfg = scatter_case(name)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        line = fn(r, s, cfg).to_dict()
    events = hj_events(prof, tmp_path)
    assert {e["name"] for e in events} <= set(profiler.SPANS)
    (join,) = [e for e in events if e["name"] == "hj.join"]
    (build,) = [e for e in events if e["name"] == "hj.build"]
    (probe,) = [e for e in events if e["name"] == "hj.probe"]
    assert inside(build, join) and inside(probe, join)
    assert build["ts"] + build["dur"] <= probe["ts"]
    readbacks = [e for e in events if e["name"] == "hj.readback"]
    assert [sum(inside(e, p) for e in readbacks)
            for p in (build, probe)] == [2, 2] == [len(readbacks) // 2] * 2
    assert line["readbacks"] == 4 and line["totalMatches"] == SCATTER_R


@pytest.mark.parametrize("name", list(SCATTER))
def test_claim_rows_count_every_row_of_every_claim_round(name):
    fn, r, s, cfg = scatter_case(name)
    before = insert.CLAIM_ROWS
    line = fn(r, s, cfg).to_dict()
    assert line["claimRows"] == SCATTER[name][1] * SCATTER_R
    assert insert.CLAIM_ROWS - before == line["claimRows"]
    assert line["inputSum"] == line["outputSum"]


@pytest.mark.parametrize("name", list(CASES))
def test_claim_rows_on_the_cells_paths(name):
    """4 |R| on the hash cell (four rounds over every row, though every
    unique key places in the first); none on the banded engine's."""
    fn, r, s, cfg = join_case(name)
    line = fn(r, s, cfg).to_dict()
    assert line["claimRows"] == (4 * R if name == "atomic" else 0)
