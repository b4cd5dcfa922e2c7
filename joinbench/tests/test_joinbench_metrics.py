"""The metric arithmetic: rates over all the work, a p95 over all samples,
idle time and kernel time from a trace, bytes counted once."""

import types

import pytest

from joinbench import cells, kernels, peaks, trace
from joinbench.loop import Join


def _join(i, seconds, tuples=10, peak=0, line=None):
    return Join(i, seconds, 0.0, peak, tuples, line or {}, None, ())


def _run(joins=(), traced=None, r_size=1 << 27, s_size=1 << 27,
         s_sorted=True, setup_s=1.0):
    cell = types.SimpleNamespace(settings=dict(
        r_size=r_size, s_size=s_size,
        s_gen=types.SimpleNamespace(SORTED=s_sorted)))
    return types.SimpleNamespace(cell=cell, joins=list(joins), traced=traced,
                                 setup_s=setup_s)


def _read(name, run):
    return cells.metric_module(name).read(run)


def test_rate_is_all_the_work_over_all_the_time():
    joins = [_join(0, 1.0, tuples=4_000_000), _join(1, 3.0, tuples=4_000_000)]
    # 8 M tuples over 4 s, not the mean of 4 and 1.33 M/s
    assert _read("join_mtuples_per_s", _run(joins)) == pytest.approx(2.0)


@pytest.mark.parametrize("n,rank", [(100, 95), (20, 19), (1, 1), (7, 7),
                                    (1000, 950)])
def test_p95_is_the_nearest_rank_over_all_samples(n, rank):
    joins = [_join(i, (n - i) * 1e-3) for i in range(n)]   # any order
    assert _read("join_ms_p95", _run(joins)) == pytest.approx(rank)


def test_peak_and_setup():
    joins = [_join(0, 1, peak=3 << 30), _join(1, 1, peak=5 << 29)]
    assert _read("peak_gib", _run(joins)) == 3.0
    assert _read("setup_s", _run(joins, setup_s=7.5)) == 7.5


def test_replan_share_reads_each_path_field():
    lines = [{"resorted": False, "conflictCount": 0, "failedTransactions": 0},
             {"resorted": True},
             {"conflictCount": 3},
             {"failedTransactions": 1, "resorted": False},
             {"totalOverflows": 2},
             {"totalOverflows": None, "conflictCount": 0}]
    joins = [_join(i, 1, line=ln) for i, ln in enumerate(lines)]
    assert _read("replan_share", _run(joins)) == pytest.approx(400 / 6)


US = 1e-6


def _events():
    """One join span [0, 100) us: two overlapping kernels, a copy, a kernel
    after the span, host events, and a second span [200, 250) with one
    kernel."""
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    return [
        x("user_annotation", trace.JOIN_SPAN, 0, 100),
        x("kernel", "fused_sort_count_kernel<16, 512>", 10, 20),
        x("kernel", "at::native::vectorized_elementwise_kernel<4>", 20, 20),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 60, 10),
        x("kernel", "radix_scatter<false>", 150, 10),
        x("cpu_op", "aten::sort", 0, 45),
        x("cuda_runtime", "cudaStreamSynchronize", 70, 29),
        x("user_annotation", trace.GENERATE_SPAN, 100, 100),
        x("user_annotation", trace.JOIN_SPAN, 200, 50),
        x("kernel", "(anonymous namespace)::radix_histogram(int const*)",
          210, 10),
        {"ph": "i", "name": "marker", "ts": 5},
    ]


def test_trace_reduces_to_joins_with_their_ops():
    joins = trace.reduce(_events())
    assert len(joins) == 2
    assert joins[0].seconds == pytest.approx(100 * US)
    assert [n for n, _, _ in joins[0].ops] == [
        "fused_sort_count_kernel<16, 512>",
        "at::native::vectorized_elementwise_kernel<4>",
        "Memcpy DtoH (Device -> Pageable)"]
    assert trace.busy_seconds(joins[0]) == pytest.approx(40 * US)
    assert trace.idle_gaps(joins[0]) == pytest.approx(
        [(0, 10 * US), (40 * US, 60 * US), (70 * US, 100 * US)])


def test_idle_share_from_the_union_of_device_intervals():
    run = _run(traced=trace.reduce(_events()))
    # busy 40 + 10 us of 150 us of spans
    assert _read("idle_pct", run) == pytest.approx(100 * (1 - 50 / 150))


def test_breakdown_names_ops_and_what_the_host_did_in_gaps():
    out = trace.breakdown(trace.reduce(_events()))
    ops = dict(out["device_ops"])
    assert ops["fused_sort_count_kernel<16, 512>"] == pytest.approx(20 * US)
    assert ops["radix_histogram"] == pytest.approx(10 * US)
    gaps = dict(out["idle_gaps"])
    # gaps 0-10 (in the sort), 40-60 and the second span's 200-210 and
    # 220-250 (between host calls), 70-100 (by its midpoint, in the
    # synchronise)
    assert gaps["aten::sort"] == pytest.approx(10 * US)
    assert gaps[trace.NO_HOST_CALL] == pytest.approx(60 * US)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(30 * US)
    assert len(out["device_ops"]) <= trace.TOP


def test_glue_is_everything_but_the_hand_written_kernels():
    run = _run(traced=trace.reduce(_events()))
    # the elementwise kernel and the copy: 20 + 10 us over two joins
    assert _read("glue_ms", run) == pytest.approx(30 * US / 2 * 1e3)


def test_k3_roofline_counts_the_keys_the_join_needs_sorted(capsys):
    k3 = cells.metric_module("k3_roofline")
    assert k3.keys_sorted(1 << 24, 1 << 28, False) == (1 << 24) + (1 << 28)
    assert k3.keys_sorted(1 << 27, 1 << 27, True) == 1 << 27
    events = _events() + [{"ph": "X", "cat": "kernel", "ts": 230, "dur": 5,
                           "name": "radix_scatter<true>"}]
    run = _run(traced=trace.reduce(events), r_size=100, s_size=50,
               s_sorted=False)
    # the histogram (10 us) and the keys-only scatter (outside any span:
    # not counted); the key-value scatter is named on standard error
    want = 100 * 8 * 150 * 2 / peaks.HBM_BYTES_PER_S / (10 * US)
    assert _read("k3_roofline", run) == pytest.approx(want)
    assert "radix_scatter<true>" in capsys.readouterr().err


def test_kernel_readers_find_nothing_without_their_kernel():
    spans = [e for e in _events() if e.get("cat") == "user_annotation"]
    run = _run(traced=trace.reduce(spans))
    for name in ("k3_roofline", "glue_ms", "idle_pct"):
        assert _read(name, run) is None
    assert _read("k3_roofline", _run(traced=None)) is None


@pytest.mark.parametrize("name,short,base", [
    ("fused_sort_count_kernel<16, 512>", "fused_sort_count_kernel<16, 512>",
     "fused_sort_count_kernel"),
    ("(anonymous namespace)::tile_minmax_kernel(int const*, int*, int)",
     "tile_minmax_kernel", "tile_minmax_kernel"),
    ("void (anonymous namespace)::radix_scatter<false>(int const*, "
     "(anonymous namespace)::Status*)", "radix_scatter<false>",
     "radix_scatter"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH (Device -> Pageable)",
     "Memcpy DtoH"),
    ("at::native::reduce_kernel<512, 1, at::native::ReduceOp<long>::operator",
     "at::native::reduce_kernel<512, 1, at::native::ReduceOp<long>::operator",
     "reduce_kernel"),
])
def test_kernel_names(name, short, base):
    assert trace.short_name(name) == short
    assert trace.base_name(name) == base


def test_the_hand_written_kernels_are_read_from_the_sources():
    known = kernels.csrc_kernels()
    assert known["fused_sort_count_kernel"] == "fused_sort_count.cu"
    assert known["radix_histogram"] == "radix_sort.cu"
    assert known["radix_scatter"] == "radix_sort.cu"
    assert known["banded_count_narrow_kernel"] == "banded_count_narrow.cu"
    assert len(known) >= 10
