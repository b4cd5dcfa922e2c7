"""The plain reference against brute force, and its control."""

from collections import Counter

import numpy as np
import pytest
import torch

from joinbench import reference


def _brute(r, s):
    counts = Counter(r.tolist())
    return {"totalMatches": sum(counts[k] for k in s.tolist()),
            "inputSum": int(sum(r.tolist())),
            "outputSum": int(sum(r.tolist()))}


@pytest.mark.parametrize("seed", range(4))
def test_reference_equals_brute_force(seed):
    rng = np.random.default_rng(seed)
    r = torch.from_numpy(rng.integers(1, 300, 2000).astype(np.int32))
    s = torch.from_numpy(rng.integers(1, 400, 5000).astype(np.int32))
    assert reference.expected(r, s) == _brute(r, s)


def test_reference_counts_across_blocks(monkeypatch):
    monkeypatch.setattr(reference, "BLOCK", 7)
    r = torch.tensor([3, 1, 2, 2, 9], dtype=torch.int32)
    s = torch.tensor([2, 2, 5, 9, 1, 1, 3, 2, 8, 9, 9, 2, 4, 2, 3],
                     dtype=torch.int32)
    assert reference.expected(r, s) == _brute(r, s)


def test_reference_of_the_cells_shapes():
    n = 1 << 12
    r = torch.randperm(n, dtype=torch.int32) + 1
    s = torch.arange(1, n + 1, dtype=torch.int32)
    want = reference.expected(r, s)
    assert want["totalMatches"] == n
    assert want["inputSum"] == want["outputSum"] == n * (n + 1) // 2


def test_control_wraps_where_the_sums_pass_32_bits():
    n = 1 << 17
    r = torch.randperm(n, dtype=torch.int32) + 1
    s = torch.arange(1, n + 1, dtype=torch.int32)
    exact = reference.expected(r, s)
    control = reference.expected(r, s, accumulator=torch.int32)
    assert control["totalMatches"] == exact["totalMatches"]
    assert control["inputSum"] != exact["inputSum"]
    assert abs(control["inputSum"] - exact["inputSum"]) % (1 << 32) == 0
