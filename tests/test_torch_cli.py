"""The port's CLI against the JAX package's: the same flags parse to the same
JoinConfig (the argv lists of ``tests/test_cli.py`` and more), lines run on
the CPU carry the JAX CLI's key set (JAX with ``--backend pallas``) and the
reference's invariants, every ``--algo`` name runs, ``--backend xla``
gives the JAX CLI's line, ``--profile``, ``--counters`` and
``--throughput`` run, and ``--meshShape`` runs the distributed join."""

import dataclasses
import json

import pytest
import torch

from htm_hashjoin_tpu import cli as jcli
from htm_hashjoin_tpu_torch import cli
from htm_hashjoin_tpu_torch.data.generators import build_relations
from htm_hashjoin_tpu_torch.utils.metrics import PORT_ONLY_FIELDS
from htm_hashjoin_tpu_torch.utils.validate import reference_match_count

CPU = torch.device("cpu")

ARGVS = [
    ["--algo", "PRO"],
    ["--algo", "NPO_st"],
    ["--algo", "NPO", "-r", "4096", "-s", "8192", "-x", "12345", "-y",
     "54321", "-n", "8"],
    ["--algo", "PRO", "-r", "4096", "-s", "4096", "-z", "1.05"],
    ["--non-unique", "-r", "1024"],
    ["-l", "64", "-r", "1024"],
    ["--algo", "NPO", "-r", "1024", "-s", "2048"],
    ["--algo", "PRO", "-r", "1024", "-s", "1024", "-z", "0"],
    ["--non-unique", "-r", "1024", "-s", "2048"],
    ["--full-range", "-r", "1024", "-s", "2048"],
    ["--algo", "PRO", "-n", "4"],
    ["--algo", "htm", "--rSize", "65536", "--dataDistr", "local_shuffle",
     "--shuffleRange", "64", "--noProbe", "--track", "--adaptive",
     "--switchSniff", "--noRetry", "--skewHandling", "--backend", "pallas",
     "--radixBits", "6", "--radixPasses", "3", "--seed", "9",
     "--distinctKeys", "77", "--zipfParam", "1.5", "--numPartitions", "16",
     "--transactionSize", "32", "--probeLength", "8", "--scaleOutput", "4",
     "--sSize", "1234", "--basic-numa"],
    ["--meshShape", "2,4", "--profile", "/nowhere", "--counters",
     "--throughput"],
]


def as_dict(cfg):
    """A JoinConfig of either package as plain values."""
    return {k: (v.value if hasattr(v, "value") else v)
            for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a)[:40])
def test_parse_args_matches_jax(argv):
    cfg, extras = cli.parse_args(argv)
    jcfg, jextras = jcli.parse_args(argv)
    assert as_dict(cfg) == as_dict(jcfg)
    assert extras == jextras


def run_line(capsys, argv, main=cli.main, **kw):
    assert main(argv, **kw) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv", [
    ["--algo", "htm", "--rSize", "16384", "--dataDistr", "local_shuffle"],
    ["--algo", "htm", "--rSize", "16384", "--dataDistr", "shuffle",
     "--noProbe"],
    ["--algo", "radix", "--rSize", "16384", "--dataDistr", "uniform",
     "--distinctKeys", "1000"],
    ["--algo", "adaptive", "--rSize", "16384", "--dataDistr", "local_shuffle",
     "--adaptive"],
    ["--algo", "PRO", "-r", "4096", "-s", "8192"],
    ["--algo", "PRO", "-r", "4096", "-s", "4096", "-z", "0.9"],
    ["--algo", "htm", "--rSize", "16384", "--dataDistr", "zipf",
     "--switchSniff"],
], ids=lambda a: " ".join(a)[:48])
def test_cli_line_has_the_jax_keys_and_invariants(capsys, argv):
    """Each package makes its own relations (JAX's threefry bits are not
    the port's), so the lines agree on their keys, and on the counts and
    sums that the configuration fixes: permutations of 1..N (sum
    N(N+1)/2, N matches) and PK x FK (s-size matches)."""
    got = run_line(capsys, argv, device=CPU)
    want = run_line(capsys, argv + ["--backend", "pallas"], main=jcli.main)
    assert set(got) == set(want) | PORT_ONLY_FIELDS
    assert got["inputSum"] == got["outputSum"]
    cfg, _ = cli.parse_args(argv)
    permutation = cfg.data_distr.value in ("local_shuffle", "shuffle", "pk")
    if permutation:
        assert got["inputSum"] == want["inputSum"] == \
            cfg.r_size * (cfg.r_size + 1) // 2
    if "--noProbe" in argv:
        assert "totalMatches" not in got
    elif cfg.s_distr is not None:                     # mc: PK x FK / zipf
        assert got["totalMatches"] == want["totalMatches"] == cfg.s_size
    else:
        r, s = build_relations(cfg)
        assert got["totalMatches"] == reference_match_count(r.keys, s.keys)
        if permutation:
            assert got["totalMatches"] == want["totalMatches"] == cfg.r_size


def test_adaptive_zipf_chooses_radix_with_exact_matches(capsys):
    argv = ["--algo", "adaptive", "--rSize", "65536", "--dataDistr", "zipf",
            "--distinctKeys", "4096"]
    line = run_line(capsys, argv, device=CPU)
    cfg, _ = cli.parse_args(argv)
    r, s = build_relations(cfg)
    assert line["chosenPath"] == "radix"
    assert line["totalMatches"] == reference_match_count(r.keys, s.keys)
    assert line["inputSum"] == line["outputSum"]


@pytest.mark.parametrize("argv", [
    ["--algo", "nocc", "--dataDistr", "uniform", "--distinctKeys", "1000"],
    ["--algo", "atomic", "--dataDistr", "uniform", "--distinctKeys", "1000"],
    ["--algo", "sortmerge", "--dataDistr", "random"],
    ["--algo", "npo", "--dataDistr", "shuffle"],
    ["--algo", "npo_st", "--dataDistr", "zipf"],
    ["--algo", "NPO", "-r", "4096", "-s", "8192"],
    ["--algo", "NPO_st", "-r", "4096", "-s", "8192", "-z", "0.9"]],
    ids=lambda a: " ".join(a)[:40])
def test_every_algorithm_runs(capsys, argv):
    """The five algorithms that raised until their modules were ported, and
    the mc names of npo, through cli.main on the CPU: the exact match count
    and conservation (nocc: its losses only lower both)."""
    if "-r" not in argv:
        argv = argv + ["--rSize", "16384"]
    line = run_line(capsys, argv, device=CPU)
    cfg, _ = cli.parse_args(argv)
    r, s = build_relations(cfg)
    exact = reference_match_count(r.keys, s.keys)
    assert line["inputSum"] == r.key_sum()
    if cfg.algo.value == "nocc":
        assert line["outputSum"] < line["inputSum"]
        assert line["totalMatches"] < exact
    else:
        assert line["outputSum"] == line["inputSum"]
        assert line["totalMatches"] == exact


@pytest.mark.parametrize("argv", [
    ["--algo", "htm", "--dataDistr", "local_shuffle"],
    ["--algo", "atomic", "--dataDistr", "uniform", "--distinctKeys", "999"],
    ["--algo", "nocc", "--dataDistr", "shuffle", "--noProbe"],
    ["--algo", "NPO", "-r", "2048", "-s", "4096"]],
    ids=lambda a: " ".join(a)[:40])
def test_backend_xla_line_equals_jax(capsys, argv):
    """--backend xla takes the scatter builds, as JAX's CLI does: the same
    line on the same relations (each package's CLI makes its own, so the
    port's join runs on the JAX CLI's keys here)."""
    from htm_hashjoin_tpu.data.generators import \
        build_relations as jbuild_relations
    from htm_hashjoin_tpu.joins import DISPATCH as JDISPATCH
    from htm_hashjoin_tpu_torch.joins import DISPATCH
    from htm_hashjoin_tpu_torch.relation import Relation, keys_from_numpy
    argv = argv + ["--backend", "xla"]
    if "-r" not in argv:
        argv = argv + ["--rSize", "4096"]
    cfg, _ = cli.parse_args(argv)
    jcfg, _ = jcli.parse_args(argv)
    jr, js = jbuild_relations(jcfg)
    want = JDISPATCH[jcfg.algo.value](jr, js, jcfg).to_dict()
    r = Relation(keys_from_numpy(jr.keys))
    s = Relation(keys_from_numpy(js.keys), assume_sorted=js.assume_sorted)
    got = DISPATCH[cfg.algo.value](r, s, cfg).to_dict()
    assert "backend" not in got
    assert {k: v for k, v in got.items()
            if "Time" not in k and k not in PORT_ONLY_FIELDS} == \
        {k: v for k, v in want.items() if "Time" not in k}
    assert PORT_ONLY_FIELDS <= set(got)
    assert set(run_line(capsys, argv, device=CPU)) == set(got)


@pytest.mark.parametrize("flags,title", [
    (["--meshShape", "8"], "Distributed")])
def test_unported_flags_raise(flags, title, capsys, tmp_path, monkeypatch):
    """The last flag that raised until its module was ported (ROADMAP queue
    1, Distributed) now runs: ``--meshShape 8`` on the CPU, with a mapping
    file that places 8 shards there, gives the JAX CLI's key set and an
    exact ``dist_htm`` line."""
    from htm_hashjoin_tpu_torch.parallel.mesh import MAPPING_ENV
    path = tmp_path / "device-mapping.txt"
    path.write_text("8 0 1 2 3 4 5 6 7\n")
    monkeypatch.setenv(MAPPING_ENV, str(path))
    argv = ["--algo", "htm", "--rSize", "1024"] + flags
    got = run_line(capsys, argv, device=CPU)
    want = run_line(capsys, argv, main=jcli.main)
    assert title == "Distributed" and set(got) == set(want)
    assert got["algo"] == want["algo"] == "dist_htm"
    assert got["totalMatches"] == want["totalMatches"] == 1024
    assert got["inputSum"] == got["outputSum"] == 1024 * 1025 // 2
    assert got["nDevices"] == 8 and got["meshShape"] == [8]
    assert got["droppedR"] == got["droppedS"] == 0


@pytest.mark.parametrize("flag", ["--profile", "--counters", "--throughput"])
def test_profiler_flags_run(flag, tmp_path, capsys):
    """--profile writes a trace of the join, --counters puts the default
    events in the line (and ends its session), --throughput prints the
    ns/tuple report after the line, as the JAX CLI does."""
    import glob
    from htm_hashjoin_tpu_torch.utils.profiler import active_counters
    argv = ["--algo", "atomic", "--rSize", "4096", "--backend", "xla", flag]
    if flag == "--profile":
        argv.append(str(tmp_path / "prof"))
    assert cli.main(argv, device=CPU) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[0])
    assert line["totalMatches"] == 4096 and "backend" not in line
    assert len(out) == (2 if flag == "--throughput" else 1)
    if flag == "--profile":
        assert glob.glob(str(tmp_path / "prof" / "*.pt.trace.json*"))
    if flag == "--counters":
        assert active_counters() is None
        assert set(line["counters"]) == {"build", "probe"}
        for events in line["counters"].values():
            assert set(events) == {"flops", "bytes", "intensity",
                                   "bandwidth"}
            assert events["bytes"] >= 4 * 4096
    else:
        assert "counters" not in line
    if flag == "--throughput":
        rep = json.loads(out[1])
        total = (line["hashBuildTimeInMicroseconds"]
                 + line["probeTimeInMicroseconds"])
        assert rep["numTuples"] == 2 * 4096
        assert rep["totalTimeUsecs"] == total
        assert rep["tuplesPerSecond"] == 2 * 4096 / (total * 1e-6)


def test_main_without_cuda_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--algo", "htm", "--rSize", "1024"])
