"""The port package on its own: imports, generators, relation helpers, the
kernel build's naming and the kernel wrappers' dispatch (which must never
run the plain version for a CUDA tensor, nor launch anything for a CPU
one), and the metrics, timer and oracle utilities."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from htm_hashjoin_tpu_torch.data.generators import (local_shuffled_keys,
                                                    sorted_keys)
from htm_hashjoin_tpu_torch.ops import _build
from htm_hashjoin_tpu_torch.ops import banded_count as bc
from htm_hashjoin_tpu_torch.ops import banded_count_narrow as bcn
from htm_hashjoin_tpu_torch.ops import fused_sort_count as fsc
from htm_hashjoin_tpu_torch.ops import global_sort as gs
from htm_hashjoin_tpu_torch.ops import global_sort_kv as gkv
from htm_hashjoin_tpu_torch.ops import scatter_tiles as sct
from htm_hashjoin_tpu_torch.ops import sort_kv_tiles as skv
from htm_hashjoin_tpu_torch.ops import sort_tiles as st
from htm_hashjoin_tpu_torch.ops import tile_minmax as tmm
from htm_hashjoin_tpu_torch.relation import keys_from_numpy, tiles_from_numpy

TILE = 2048


def test_import_pulls_in_no_jax_and_builds_nothing():
    code = (
        "import sys\n"
        "import htm_hashjoin_tpu_torch, htm_hashjoin_tpu_torch.bench\n"
        "import htm_hashjoin_tpu_torch.cli, htm_hashjoin_tpu_torch.config\n"
        "from htm_hashjoin_tpu_torch.joins import (adaptive, atomic, common,"
        " htm, nocc, npo, radix, sortmerge)\n"
        "from htm_hashjoin_tpu_torch.ops import (hashing, insert, partition,"
        " probe, radix_kernels, scatter_tiles, sortops, global_sort_kv,"
        " sort_kv_tiles)\n"
        "import htm_hashjoin_tpu_torch.wisconsin\n"
        "import htm_hashjoin_tpu_torch.wisconsin.__main__\n"
        "from htm_hashjoin_tpu_torch.utils import (device, metrics, profiler,"
        " timing, validate)\n"
        "from htm_hashjoin_tpu_torch.data import native, persist\n"
        "import htm_hashjoin_tpu_torch.benchmarks.__main__\n"
        "import htm_hashjoin_tpu_torch.harness.__main__\n"
        "from htm_hashjoin_tpu_torch.ops import _build\n"
        "from htm_hashjoin_tpu_torch.parallel import (mesh, collectives,"
        " dist_join, scaling, dryrun)\n"
        "import htm_hashjoin_tpu_torch.entry\n"
        "import htm_hashjoin_tpu_torch.harness.report\n"
        "from htm_hashjoin_tpu_torch.experiments import (adaptive_dial_bench,"
        " radix_crossover)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('htm_hashjoin_tpu.') or m == 'htm_hashjoin_tpu']\n"
        "print(bad, _build.build.cache_info().currsize,"
        " _build.load_library.cache_info().currsize)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.split() == ["[]", "0", "0"]


@pytest.mark.parametrize("n,window", [(1000, 16), (4096, 1), (5000, 64),
                                      (1 << 14, 512)])
def test_local_shuffle_invariants(n, window):
    keys = local_shuffled_keys(n, window, 7)
    assert keys.dtype == torch.int32 and keys.shape == (n,)
    a = keys.numpy()
    np.testing.assert_array_equal(np.sort(a), np.arange(1, n + 1))
    assert np.abs(a - np.arange(1, n + 1)).max() <= window
    assert torch.equal(keys, local_shuffled_keys(n, window, 7))
    if window > 1:
        assert not torch.equal(keys, local_shuffled_keys(n, window, 8))


def test_sorted_keys():
    assert sorted_keys(5).tolist() == [1, 2, 3, 4, 5]
    assert sorted_keys(5).dtype == torch.int32


def test_tiles_from_numpy_round_trips():
    rng = np.random.default_rng(0)
    arr2d = rng.integers(-2**31, 2**31 - 1, (16, 128)).astype(np.int32)
    flat = tiles_from_numpy(arr2d)
    assert flat.dtype == torch.int32 and flat.is_contiguous()
    np.testing.assert_array_equal(flat.view(-1, 128).numpy(), arr2d)
    with pytest.raises(ValueError):
        tiles_from_numpy(arr2d.reshape(32, 64))
    with pytest.raises(ValueError):
        keys_from_numpy(arr2d)
    with pytest.raises(ValueError):
        keys_from_numpy(np.array([1, 2**31], np.int64))


def k1_args(device="cpu", n_tiles=2):
    r = torch.arange(n_tiles * TILE, 0, -1, dtype=torch.int32, device=device)
    s = torch.arange(1, (n_tiles + 17) * TILE + 1, dtype=torch.int32,
                     device=device)
    zeros = torch.zeros(n_tiles, dtype=torch.int32, device=device)
    return r, s, zeros, zeros.clone()


def test_plain_path_does_not_count_launches():
    before = fsc.LAUNCHES
    out = fsc.fused_sort_count(*k1_args(), tile=TILE, method="bitonic")
    assert fsc.LAUNCHES == before
    assert out[0].dtype == torch.int32 and out[1].shape == (2, 3)
    assert out[2].dtype == torch.int64 and out[3].dtype == torch.int32


def test_cuda_tensor_without_cuda_raises_and_never_runs_plain(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    def plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(fsc, "fused_sort_count_ref", plain)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = k1_args("cuda")
    before = fsc.LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fsc.fused_sort_count(*args, tile=TILE, method="blocks", passes=16)
    assert fsc.LAUNCHES == before


def test_other_device_raises():
    with pytest.raises(ValueError, match="cpu or cuda"):
        fsc.fused_sort_count(*k1_args("meta"), tile=TILE, method="bitonic")


@pytest.mark.parametrize("bad", ["dtype", "2d", "row_off", "tile", "ragged",
                                 "method", "passes", "short_s", "devices"])
def test_bad_arguments_raise(bad):
    r, s, row_off, rows_needed = k1_args()
    kw = dict(tile=TILE, method="oddeven", passes=4)
    if bad == "dtype":
        r = r.to(torch.int64)
    elif bad == "2d":
        r = r.view(-1, 128)
    elif bad == "row_off":
        row_off = row_off[:1]
    elif bad == "tile":
        kw["tile"] = 3000
    elif bad == "ragged":
        r = r[:-128]
    elif bad == "method":
        kw["method"] = "radix"
    elif bad == "passes":
        kw["passes"] = 0
    elif bad == "short_s":
        s = s[:TILE]
    elif bad == "devices":
        s = s.to("meta")
    with pytest.raises(ValueError):
        fsc.fused_sort_count(r, s, row_off, rows_needed, **kw)


def test_band_past_probe_end_raises_on_cpu():
    r, s, row_off, rows_needed = k1_args()
    row_off[1] = s.numel() // 128 - 8
    with pytest.raises(ValueError, match="prepare_probe_side"):
        fsc.fused_sort_count(r, s, row_off, rows_needed, tile=TILE,
                             method="bitonic")


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    header = tmp_path / "shared.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    first = _build.library_path()
    assert first.parent == _build.BUILD_DIR
    src.write_text("// two\n")
    second = _build.library_path()
    assert second != first
    header.write_text("// two\n")           # a header alone changes the name
    assert _build.library_path() not in (first, second)


def other_kernel_calls(device="cpu"):
    """(module, plain-version name, call) of K2-K6, K7a, K7 and K1's band
    prepass on 2 tiles."""
    keys = torch.arange(2 * TILE, dtype=torch.int32, device=device)
    s = torch.arange((2 + 17) * TILE, dtype=torch.int32, device=device)
    zeros = torch.zeros(2, dtype=torch.int32, device=device)
    plan = torch.zeros((2, 4), dtype=torch.int32, device=device)
    return [
        (st, "sort_tiles_ref",
         lambda: st.sort_tiles(keys, tile=TILE, method="bitonic_alt")),
        (gs, "global_sort_ref",
         lambda: gs.global_sort_tiles(keys, tile=TILE)),
        (bc, "banded_count_ref",
         lambda: bc.banded_count(keys, s, zeros, zeros + 1, tile=TILE)),
        (bcn, "narrow_count_ref",
         lambda: bcn.banded_count_narrow(keys, s, zeros, zeros, tile=TILE)),
        (sct, "scatter_tiles_ref",
         lambda: sct.scatter_tiles(keys, plan, plan, tile=TILE,
                                   out_rows=TILE // 128)),
        (skv, "sort_kv_tiles_ref",
         lambda: skv.sort_kv_tiles(keys, keys, tile=TILE, alternate=True)),
        (gkv, "global_sort_kv_ref",
         lambda: gkv.global_sort_kv_tiles(keys, keys, tile=TILE)),
        (tmm, "tile_minmax_ref", lambda: tmm.tile_minmax(keys, TILE)),
    ]


@pytest.mark.parametrize("k", range(8))
def test_other_kernels_plain_path_counts_no_launch(k):
    mod, _, call = other_kernel_calls()[k]
    before = (mod.LAUNCHES, st.LAUNCHES)
    out = call()
    assert (mod.LAUNCHES, st.LAUNCHES) == before
    first = out[0] if isinstance(out, tuple) else out
    assert first.device.type == "cpu"


@pytest.mark.parametrize("k", range(8))
def test_other_kernels_cuda_without_cuda_raise_and_never_run_plain(
        k, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    def plain(*a, **kw):
        raise AssertionError("the plain version ran for a CUDA tensor")

    with FakeTensorMode(allow_non_fake_inputs=True):
        mod, ref, call = other_kernel_calls("cuda")[k]
    monkeypatch.setattr(mod, ref, plain)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = mod.LAUNCHES
    with FakeTensorMode(allow_non_fake_inputs=True):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert mod.LAUNCHES == before


@pytest.mark.parametrize("k", range(8))
def test_other_kernels_other_device_raises(k):
    with pytest.raises(ValueError, match="cpu or cuda"):
        other_kernel_calls("meta")[k][2]()


def test_metrics_schema_matches_jax():
    from htm_hashjoin_tpu.utils.metrics import JoinMetrics as JaxMetrics
    from htm_hashjoin_tpu_torch.utils.metrics import JoinMetrics
    for algo in ("htm", "atomic", "radix"):
        fields = dict(algo=algo, rSize=64, transactionSize=16,
                      conflictCount=2, totalMatches=64, inputSum=5,
                      outputSum=5, firstRoundFailureFraction=0.5)
        got, want = JoinMetrics(**fields), JaxMetrics(**fields)
        got.extra["backend"] = want.extra["backend"] = "pallas_banded"
        assert got.to_json_line() == want.to_json_line()
        assert got.conserved


def test_oracles_and_relation():
    from htm_hashjoin_tpu.utils import validate as jvalidate
    from htm_hashjoin_tpu_torch.relation import Relation, next_pow2
    from htm_hashjoin_tpu_torch.utils import validate
    rng = np.random.default_rng(2)
    r = rng.integers(1, 40, 500).astype(np.int32)
    s = rng.integers(20, 60, 700).astype(np.int32)
    want = jvalidate.reference_match_count(r, s)
    assert validate.reference_match_count(torch.from_numpy(r),
                                          torch.from_numpy(s)) == want
    assert validate.reference_match_count(r, s) == want
    assert validate.key_sum(torch.from_numpy(r)) == int(r.sum())
    validate.assert_conserved(3, 3)
    with pytest.raises(AssertionError, match="lost 1"):
        validate.assert_conserved(4, 3, "ctx")
    rel = Relation(torch.from_numpy(r))
    assert rel.fence() is rel and rel.num_tuples == 500
    assert rel.key_sum() == int(r.astype(np.int64).sum())
    assert [next_pow2(v) for v in (0, 1, 2, 3, 1000)] == [1, 1, 2, 4, 1024]


def test_phase_timer_records_phases():
    from htm_hashjoin_tpu_torch.utils.timing import PhaseTimer
    timer = PhaseTimer()
    out = timer.timed("build", lambda x: (x + 1, [x * 2]), torch.ones(3))
    timer.timed("build", lambda: None)
    timer.timed("probe", lambda: (torch.zeros(1), 3))
    assert torch.equal(out[0], torch.full((3,), 2.0))
    assert set(timer.micros) == {"build", "probe"}
    assert min(timer.micros.values()) > 0
