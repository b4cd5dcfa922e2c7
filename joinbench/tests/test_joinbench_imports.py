"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (``htm_hashjoin_tpu_torch`` begins with
``htm_hashjoin_tpu``); the reference and the generators import nothing of
the program."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "htm_hashjoin_tpu"}
PROGRAM = "htm_hashjoin_tpu_torch"
SOURCES = sorted(p for p in (ROOT / "joinbench").rglob("*.py")
                 if "tests" not in p.relative_to(ROOT).parts)


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [ROOT / "joinbench" / "peaks.py",
                                  *(p for p in SOURCES
                                    if p.name.endswith("reference.py")),
                                  *sorted((ROOT / "joinbench" / "gen")
                                          .glob("*.py"))],
                         ids=lambda p: p.name)
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert PROGRAM not in _top_level_imports(path)


def test_the_whole_name_is_compared():
    from joinbench import run
    assert run.FORBIDDEN == FORBIDDEN
    assert run.forbidden_modules(["htm_hashjoin_tpu_torch",
                                  "htm_hashjoin_tpu_torch.ops", "jaxtyping",
                                  "flaxen"]) == []
    assert run.forbidden_modules(["jax.numpy", "htm_hashjoin_tpu.joins",
                                  "flax", "jaxlib.xla_client"]) == [
        "flax", "htm_hashjoin_tpu", "jax", "jaxlib"]


def test_a_run_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, {root!r}); "
        "sys.path.insert(0, {tests!r}); "
        "from conftest import cpu_run; "
        "from joinbench import run; "
        "r = cpu_run('adaptive_2e27.shuffle'); "
        "print('FOUND', run.forbidden_modules(), "
        "'htm_hashjoin_tpu_torch' in sys.modules)"
    ).format(root=str(ROOT), tests=str(ROOT / "joinbench" / "tests"))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert done.returncode == 0, done.stderr
    assert "FOUND [] True" in done.stdout


def test_a_module_loaded_by_the_metric_readers_stops_the_line(
        monkeypatch, capsys):
    """The look at ``sys.modules`` comes after the result is built, so what
    a metric reader loads is caught too."""
    import types

    import torch
    from conftest import cpu_run

    from joinbench import loop, report, run

    small = cpu_run("adaptive_2e27.shuffle")
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "card")
    monkeypatch.setattr(report, "power_limit", lambda: "card")
    monkeypatch.setattr(loop, "run", lambda *a, **k: small)
    built = report.result

    def result(*a):
        out = built(*a)
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return out
    monkeypatch.setattr(report, "result", result)
    argv = ["--workload", "adaptive_2e27.shuffle", "--seed", "1",
            "--seconds", "0.05"]
    assert run.main(argv) == 3
    printed = capsys.readouterr()
    assert '"correct"' not in printed.out and "jax" in printed.err
