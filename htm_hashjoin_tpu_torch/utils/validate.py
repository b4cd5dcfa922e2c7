"""Correctness oracles (counterpart of ``htm_hashjoin_tpu/utils/validate.py``).

The reference's correctness methodology is embedded in its benchmark
outputs: conservation checksums (inputSum == outputSum,
HTMHashBuild.hpp:312-401), known-cardinality match counts (PK ⋈ sorted ⇒
matches == rSize) and fixed-seed determinism.
"""

from __future__ import annotations

import numpy as np
import torch


def _numpy(keys) -> np.ndarray:
    if isinstance(keys, torch.Tensor):
        return keys.cpu().numpy()
    return np.asarray(keys)


def key_sum(keys) -> int:
    """Exact Σ keys in int64 (inputSum)."""
    if isinstance(keys, torch.Tensor):
        return int(torch.sum(keys, dtype=torch.int64))
    return int(np.sum(np.asarray(keys), dtype=np.int64))


def reference_match_count(r_keys, s_keys) -> int:
    """Oracle join cardinality computed on the host with numpy (multiset
    semantics): the ground truth for totalMatches."""
    r = _numpy(r_keys)
    s = _numpy(s_keys)
    r_vals, r_counts = np.unique(r, return_counts=True)
    s_vals, s_counts = np.unique(s, return_counts=True)
    if not len(r_vals):
        return 0
    idx = np.searchsorted(r_vals, s_vals)
    idx = np.clip(idx, 0, len(r_vals) - 1)
    hit = r_vals[idx] == s_vals
    return int(np.sum(r_counts[idx][hit].astype(np.int64) *
                      s_counts[hit].astype(np.int64)))


def check(ok: bool, what: str) -> None:
    """Raise AssertionError(what) unless ``ok``: an assert that ``python
    -O`` keeps."""
    if not ok:
        raise AssertionError(what)


def assert_conserved(input_sum: int, output_sum: int, context: str = "") -> None:
    if input_sum != output_sum:
        raise AssertionError(
            f"conservation violated{': ' + context if context else ''}: "
            f"inputSum={input_sum} outputSum={output_sum} "
            f"(lost {input_sum - output_sum})")
