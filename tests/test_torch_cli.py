"""The port's CLI against the JAX package's: the same flags parse to the same
JoinConfig (the argv lists of ``tests/test_cli.py`` and more), lines run on
the CPU carry the JAX CLI's key set (JAX with ``--backend pallas``) and the
reference's invariants, and what is not ported yet raises, naming its
ROADMAP item."""

import dataclasses
import json

import pytest
import torch

from htm_hashjoin_tpu import cli as jcli
from htm_hashjoin_tpu_torch import cli
from htm_hashjoin_tpu_torch.data.generators import build_relations
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
    assert set(got) == set(want)
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


@pytest.mark.parametrize("algo", ["nocc", "atomic", "sortmerge", "npo",
                                  "npo_st", "NPO", "NPO_st"])
def test_unported_algorithms_raise(algo):
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        cli.main(["--algo", algo, "--rSize", "1024"], device=CPU)


@pytest.mark.parametrize("flags,item", [
    (["--meshShape", "8"], "item 10"), (["--profile", "/nowhere"], "item 9"),
    (["--counters"], "item 9"), (["--throughput"], "item 9"),
    (["--backend", "xla"], "item 7")])
def test_unported_flags_raise(flags, item):
    with pytest.raises(NotImplementedError, match=f"queue 1 {item}"):
        cli.main(["--algo", "htm", "--rSize", "1024"] + flags, device=CPU)


def test_main_without_cuda_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--algo", "htm", "--rSize", "1024"])
