"""The port's scaling harness (``parallel/scaling.py``) on the CPU: the
counterparts of ``tests/test_scaling.py``, with 8 shards placed on the one
CPU device by a device-mapping file, plus ``main`` writing ``scaling_log``
and ``SCALING.md`` into its own default directory (never the JAX package's
committed ``experiments/results_scaling``).  Every point is held to the
exact count of its relations (PK ⋈ sorted or zipf FK: nS matches) and to
the JAX package's point on the same configuration."""

import json

import pytest
import torch

from htm_hashjoin_tpu.parallel.scaling import scaling_point as jscaling_point
from htm_hashjoin_tpu_torch.parallel import scaling
from htm_hashjoin_tpu_torch.parallel.mesh import MAPPING_ENV
from htm_hashjoin_tpu_torch.parallel.scaling import (main, scaling_point,
                                                     scaling_sweep)

CPU = torch.device("cpu")
UNTIMED = ("mesh", "ndev", "nR", "nS", "data", "matches", "repairFired",
           "overflowR", "overflowS", "matchesExpected", "exact")


@pytest.fixture(autouse=True)
def mapping8(tmp_path, monkeypatch):
    path = tmp_path / "device-mapping.txt"
    path.write_text("8 0 1 2 3 4 5 6 7\n")
    monkeypatch.setenv(MAPPING_ENV, str(path))


def test_scaling_point_phases_and_exactness():
    pt = scaling_point((4,), 1 << 12, 1 << 12, data="uniform", reps=1,
                       device=CPU)
    assert pt["exact"] and pt["matches"] == 1 << 12
    assert pt["exchangeTimeUs"] > 0 and pt["joinTimeUs"] > 0
    assert pt["totalTimeUs"] >= pt["exchangeTimeUs"] + pt["joinTimeUs"]
    assert not pt["repairFired"] and pt["repairTimeUs"] == 0.0


def test_scaling_point_hierarchical_zipf_repairs():
    pt = scaling_point((2, 4), 1 << 13, 1 << 13, data="zipf",
                       zipf_theta=1.2, reps=1, device=CPU)
    assert pt["exact"], pt
    # the phase split surfaces repair cost if and only if repair fired
    assert (pt["repairTimeUs"] > 0) == pt["repairFired"]
    assert pt["overflowS"] > 0


@pytest.mark.parametrize("shape,data,skew", [((8,), "zipf", False),
                                             ((2, 2), "uniform", False),
                                             ((4,), "zipf+skew", True)])
def test_scaling_point_fields_equal_jax(shape, data, skew):
    """The same configuration in both packages (each draws its own zipf
    keys, so the overflow counts are compared only on sorted S)."""
    n = 1 << 12
    got = scaling_point(shape, n, n, data=data, zipf_theta=1.2, reps=1,
                        skew_handling=skew, device=CPU)
    want = jscaling_point(shape, n, n, data=data, zipf_theta=1.2, reps=1,
                          skew_handling=skew)
    keys = [k for k in UNTIMED if data == "uniform" or
            not k.startswith("overflow") and k != "repairFired"]
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert set(got) == set(want) and got["exact"]


def test_scaling_sweep_writes_log(tmp_path):
    out = tmp_path / "scaling_log"
    lines = scaling_sweep(str(out), per_dev_log2=10, strong_log2=12,
                          reps=1, meshes=((1,), (2,), (2, 2)), echo=False,
                          device=CPU)
    logged = [json.loads(x) for x in out.read_text().splitlines()]
    # modes × meshes × data variants (uniform, zipf, zipf+skew)
    assert len(logged) == len(lines) == 2 * 3 * 3
    assert all(p["exact"] for p in logged)
    assert all("efficiency" in p for p in logged)
    assert {p["mode"] for p in logged} == {"weak", "strong"}


def test_main_writes_its_own_directory(tmp_path, monkeypatch, capsys):
    """``main`` without --outDir writes scaling_log and SCALING.md under
    experiments/results_scaling_torch; a mesh larger than the mapping is
    skipped, and the summary names the mesh virtual (one device
    repeated)."""
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "map4.txt"
    path.write_text("4 0 1 2 3\n")
    monkeypatch.setenv(MAPPING_ENV, str(path))
    assert main(["--perDevLog2", "9", "--strongLog2", "11", "--reps", "1"],
                device=CPU) == 0
    assert scaling.OUT_DIR != "experiments/results_scaling"
    out = tmp_path / scaling.OUT_DIR
    rows = [json.loads(x) for x in
            (out / "scaling_log").read_text().splitlines()]
    assert {tuple(p["mesh"]) for p in rows} == {(1,), (2,), (4,), (2, 2)}
    assert len(rows) == 2 * 4 * 3 and all(p["exact"] for p in rows)
    md = (out / "SCALING.md").read_text()
    assert md.startswith("# Scaling efficiency (virtual mesh)")
    assert md.count("| weak |") == md.count("| strong |") == 12
    assert capsys.readouterr().out.endswith(md)   # after the echoed points
    assert not (tmp_path / "experiments" / "results_scaling").exists()


def test_scaling_needs_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        scaling_point((1,), 1 << 10, 1 << 10, reps=1)
