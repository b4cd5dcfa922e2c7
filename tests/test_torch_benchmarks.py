"""The port's microbenchmarks (``benchmarks/``) against the JAX package's on
the CPU: the testbed's report keys, and the chunk sweep's failure
fractions equal to JAX's ``chunk_failure_fractions`` of JAX's
``htm_optimistic_build`` on the same keys."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htm_hashjoin_tpu import benchmarks as jbenchmarks
from htm_hashjoin_tpu.ops import insert as jinsert
from htm_hashjoin_tpu_torch import benchmarks
from htm_hashjoin_tpu_torch.benchmarks import simple
from htm_hashjoin_tpu_torch.benchmarks.__main__ import main
from htm_hashjoin_tpu_torch.joins.common import htm_num_buckets

CPU = torch.device("cpu")


def test_memory_bandwidth_has_the_jax_keys():
    got = benchmarks.memory_bandwidth(log2_elems=12, reps=2, device=CPU)
    want = jbenchmarks.memory_bandwidth(log2_elems=12, reps=2)
    assert set(got) == set(want) | {"device"}
    assert got["device"] == "cpu"
    for key in ("benchmark", "elems", "bytes", "chain"):
        assert got[key] == want[key]
    assert got["gbps"] > 0 and got["gbpsSingleFenced"] > 0
    assert got["bestTimeUsecs"] > 0 and got["singleFencedTimeUsecs"] > 0
    assert got["gbps"] == pytest.approx(
        2 * got["bytes"] / got["bestTimeUsecs"] / 1e3)


def keys_of(kind, n):
    rng = np.random.default_rng(11)
    if kind == "duplicates":
        return np.sort(rng.integers(1, n // 4, n)).astype(np.int32)
    if kind == "past the buckets":       # keys wrap the bucket mask
        return rng.permutation(np.arange(1, 8 * n + 1, 8)).astype(np.int32)
    return None                           # the sweep's own keys


@pytest.mark.parametrize("kind", ["local shuffle", "duplicates",
                                  "past the buckets"])
def test_chunk_sweep_fractions_equal_jax(kind, monkeypatch):
    log2_n, max_log2 = 12, 7
    n = 1 << log2_n
    given = keys_of(kind, n)
    if given is not None:
        monkeypatch.setattr(simple, "local_shuffled_keys",
                            lambda *a: torch.from_numpy(given))
    rows = benchmarks.chunk_sweep(log2_n, max_log2, shuffle_window=8,
                                  device=CPU)
    keys = given if given is not None else \
        simple.local_shuffled_keys(n, 8, 0, CPU).numpy()
    jfailed = jinsert.htm_optimistic_build(
        jnp.asarray(keys), htm_num_buckets(n), retry=False).failed_optimistic
    jrows = jbenchmarks.chunk_sweep(log2_n, max_log2, shuffle_window=8)
    assert len(rows) == max_log2 + 1
    any_failed = False
    for i, (row, jrow) in enumerate(zip(rows, jrows)):
        assert set(row) == set(jrow)
        assert row["chunkSize"] == jrow["chunkSize"] == 1 << i
        assert row["rSize"] == n and row["shuffleWindow"] == 8
        fracs = jinsert.chunk_failure_fractions(jfailed, 1 << i)
        assert row["maxFailureFraction"] == float(jnp.max(fracs))
        assert row["meanFailureFraction"] == pytest.approx(
            float(jnp.mean(fracs)), rel=1e-6)
        any_failed |= row["maxFailureFraction"] > 0
    assert any_failed == (given is not None)


def test_benchmarks_cli(monkeypatch, capsys):
    assert main([]) == 2
    assert main(["nope"]) == 2
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["testbed", "--log2Elems", "10"], ["simple", "--log2N",
                                                     "10"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
