"""The port's experiment harness (``harness/``) against the JAX package's:
the same grids config for config, lines with the JAX key set whose values
equal the port's DISPATCH on the same relations, the log files,
``--pipelineDepth`` and ``--counters`` in every line, all on the CPU."""

import dataclasses
import json

import pytest
import torch

from htm_hashjoin_tpu import harness as jharness
from htm_hashjoin_tpu_torch import harness
from htm_hashjoin_tpu_torch.data.generators import build_relations
from htm_hashjoin_tpu_torch.harness import GRIDS, RUNNER_ORDER, runner
from htm_hashjoin_tpu_torch.harness.__main__ import main
from htm_hashjoin_tpu_torch.joins import DISPATCH
from htm_hashjoin_tpu_torch.utils import profiler

CPU = torch.device("cpu")


def as_dict(cfg):
    """A JoinConfig of either package as plain values."""
    return {k: (v.value if hasattr(v, "value") else v)
            for k, v in dataclasses.asdict(cfg).items()}


def untimed(line: dict) -> dict:
    return {k: v for k, v in line.items() if "Time" not in k}


def test_registry_and_runner_order_equal_jax():
    assert list(GRIDS) == list(jharness.GRIDS)
    assert RUNNER_ORDER == jharness.RUNNER_ORDER
    assert harness.run_grid is runner.run_grid


@pytest.mark.parametrize("scale", range(4, 9))
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_equals_jax_config_for_config(name, scale):
    got = [as_dict(c) for c in GRIDS[name](scale)]
    want = [as_dict(c) for c in jharness.GRIDS[name](scale)]
    assert got == want and got


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_run_config_line_has_the_jax_key_set(name):
    """Both packages on their scatter builds and sort routes (``xla``): the
    JAX package's CPU backend, and keys that do not hang on a plan."""
    cfg = dataclasses.replace(next(iter(GRIDS[name](6))), backend="xla")
    jcfg = dataclasses.replace(next(iter(jharness.GRIDS[name](6))),
                               backend="xla")
    got = json.loads(harness.run_config(cfg, CPU))
    want = json.loads(jharness.run_config(jcfg))
    assert set(got) == set(want)
    assert got["inputSum"] == want["inputSum"] and \
        got["rSize"] == want["rSize"]


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_run_config_equals_dispatch_on_the_same_relations(name):
    for cfg in list(GRIDS[name](6))[:3]:
        got = json.loads(harness.run_config(cfg, CPU))
        r, s = build_relations(cfg, CPU)
        m = DISPATCH[cfg.algo.value](r, s, cfg)
        if cfg.s_distr is not None:
            m.extra["sDistr"] = cfg.s_distr.value
            m.extra["zipfParam"] = cfg.zipf_param
        assert untimed(got) == untimed(m.to_dict())
        assert got["inputSum"] == got["outputSum"]


@pytest.mark.parametrize("name,scale", [("AtomicsVsHTMVsNoCC", 10),
                                        ("adaptive2", 6), ("track", 5)])
def test_run_grid_writes_logs(name, scale, tmp_path):
    lines = harness.run_grid(name, scale=scale, reps=2, out_dir=str(tmp_path),
                             echo=False, device=CPU)
    points = len(list(GRIDS[name](scale)))
    assert len(lines) == points
    for rep in (1, 2):
        rows = (tmp_path / f"{name}_log{rep}").read_text().strip().split("\n")
        assert len(rows) == points
        for row in rows:
            d = json.loads(row)
            assert d["inputSum"] == d["outputSum"]
    assert not (tmp_path / f"{name}_log3").exists()


def test_pipeline_depth_adds_its_fields(tmp_path, capsys):
    assert main(["probe", "--scale", "6", "--reps", "1", "--outDir",
                 str(tmp_path), "--pipelineDepth", "3"], device=CPU) == 0
    echoed = capsys.readouterr().out.strip().split("\n")
    rows = [json.loads(r) for r in
            (tmp_path / "probe_log1").read_text().strip().split("\n")]
    assert [json.loads(r) for r in echoed] == rows
    assert len(rows) == 3 * 7
    clean = [d for d in rows if d["resorted"] is False]
    assert clean
    for d in clean:
        assert d["pipelineDepth"] == 3
        assert d["singleRunTimeInMicroseconds"] > 0
    for d in rows:
        assert d["totalMatches"] == 64 and d["inputSum"] == d["outputSum"]


@pytest.mark.parametrize("name", ["AtomicsVsHTMVsNoCC", "motivation",
                                  "skewprobe"])
def test_counters_flag_puts_counters_in_every_line(name, tmp_path, capsys):
    profiler.disable_counters()
    assert main([name, "--scale", "6", "--reps", "1", "--counters",
                 "--outDir", str(tmp_path)], device=CPU) == 0
    capsys.readouterr()
    assert profiler.active_counters() is None
    rows = (tmp_path / f"{name}_log1").read_text().strip().split("\n")
    assert len(rows) == len(list(GRIDS[name](6)))
    for row in rows:
        counters = json.loads(row)["counters"]
        assert counters
        for events in counters.values():
            assert set(events) == {"flops", "bytes", "intensity",
                                   "bandwidth"}
            assert events["bytes"] > 0


def test_counters_config_file_programs_the_events(tmp_path, capsys):
    cfg = tmp_path / "pcm.cfg"
    cfg.write_text("mem=bytes accessed\nai=arithmetic_intensity\n")
    assert main(["adaptive2", "--scale", "5", "--reps", "1", "--counters",
                 str(cfg), "--outDir", str(tmp_path)], device=CPU) == 0
    capsys.readouterr()
    for row in (tmp_path / "adaptive2_log1").read_text().strip().split("\n"):
        for events in json.loads(row)["counters"].values():
            assert set(events) == {"mem", "ai"}


def test_all_writes_its_own_log_directory(monkeypatch, tmp_path, capsys):
    """``all`` without --outDir logs beside the JAX runner's
    experiments/logs, never into it."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(runner, "RUNNER_ORDER", ["track", "adaptive2"])
    assert main(["all", "--scale", "5", "--reps", "1"], device=CPU) == 0
    capsys.readouterr()
    logs = tmp_path / runner.LOG_DIR
    assert sorted(p.name for p in logs.iterdir()) == ["adaptive2_log1",
                                                      "track_log1"]
    assert runner.LOG_DIR != "experiments/logs"
    assert not (tmp_path / "experiments" / "logs").exists()


def test_mesh_shape_and_unknown_grids_raise():
    """An unknown grid raises; a config with a mesh_shape runs (the next
    test)."""
    with pytest.raises(ValueError, match="unknown grid"):
        harness.run_grid("nope", scale=5, device=CPU)


def test_mesh_shape_config_runs_the_distributed_join(tmp_path, monkeypatch):
    """A grid config with ``mesh_shape=(2,)`` runs the distributed join on
    two CPU shards (a two-line mapping file): its line equals
    ``distributed_join`` on the same relations, exactly."""
    from htm_hashjoin_tpu_torch.parallel.dist_join import distributed_join
    from htm_hashjoin_tpu_torch.parallel.mesh import MAPPING_ENV
    path = tmp_path / "device-mapping.txt"
    path.write_text("2\n0\n1\n")
    monkeypatch.setenv(MAPPING_ENV, str(path))
    cfg = dataclasses.replace(next(iter(GRIDS["probe"](5))), mesh_shape=(2,))
    got = json.loads(harness.run_config(cfg, CPU))
    r, s = build_relations(cfg, CPU)
    want = distributed_join(r, s, cfg).to_dict()
    assert untimed(got) == untimed(want)
    assert got["algo"] == f"dist_{cfg.algo.value}" and got["nDevices"] == 2
    assert got["totalMatches"] == 32 and got["inputSum"] == got["outputSum"]
    runner.clear_cache()


def test_entry_points_need_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["track", "--scale", "4", "--reps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        harness.run_config(next(iter(GRIDS["track"](4))))
    runner.clear_cache()


def test_report_conserved_allows_losses_to_nocc_only():
    from htm_hashjoin_tpu_torch.harness import report
    line = {"algo": "atomic", "inputSum": 10, "outputSum": 10}
    assert report.conserved(line)
    assert not report.conserved({**line, "outputSum": 9})
    assert report.conserved({**line, "algo": "nocc", "outputSum": 9})
    assert not report.conserved({**line, "algo": "nocc", "outputSum": 11})
    s = report.grid_summary([
        {**line, report.BUILD: 5.0}, {**line, "outputSum": 9,
                                      report.BUILD: 2.0}])
    assert s == {"points": 2, "conserved": 1, "buildMinUs": 2.0,
                 "buildMedianUs": 3.5, "buildMaxUs": 5.0}


def test_report_pairs_the_motivation_grid_by_window(tmp_path):
    """PRO's lines are the grid's first scale + 1, the adaptive HTM
    build's its last scale + 1; each window's numbers are the medians over
    the reps."""
    from htm_hashjoin_tpu_torch.harness import report
    scale = 6
    harness.run_grid("motivation", scale=scale, reps=3, echo=False,
                     out_dir=str(tmp_path), device=CPU)
    reps = report.read_logs(str(tmp_path))["motivation"]
    assert len(reps) == 3 and all(len(r) == 4 * (scale + 1) for r in reps)
    ratios = report.motivation_ratios(reps)
    assert [r["window"] for r in ratios] == [1 << i for i in range(scale + 1)]
    for i, r in enumerate(ratios):
        pro = sorted(rep[i][report.BUILD] for rep in reps)[1]
        htm = sorted(rep[3 * (scale + 1) + i][report.BUILD]
                     for rep in reps)[1]
        assert [rep[i]["algo"] for rep in reps] == ["radix"] * 3
        assert [rep[3 * (scale + 1) + i]["algo"] for rep in reps] == \
            ["htm"] * 3
        assert (r["proUs"], r["htmUs"], r["ratio"]) == (pro, htm, pro / htm)
    lines = report.motivation_lines(ratios)
    assert len(lines) == scale + 2
    assert lines[-1].startswith("motivation: HTM beats PRO by 2x or more at")


def test_report_main_summarises_every_grid(tmp_path, capsys):
    from htm_hashjoin_tpu_torch.harness import report
    with pytest.raises(FileNotFoundError):
        report.main([str(tmp_path)])
    for name in ("SizeToAbortsAndTimeSorted", "AtomicsVsHTMVsNoCC"):
        harness.run_grid(name, scale=6, reps=2, echo=False,
                         out_dir=str(tmp_path), device=CPU)
    (tmp_path / "AtomicsVsHTMVsNoCC_log2.bak").write_text("not a log\n")
    assert report.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == [
        next(x for x in out if x.startswith("SizeToAbortsAndTimeSorted: 2 "
                                            "reps, 13 points a rep, 26 of "
                                            "26 lines conserve")),
        next(x for x in out if x.startswith("AtomicsVsHTMVsNoCC: 2 reps, 6 "
                                            "points a rep, 12 of 12 lines "
                                            "conserve"))]
