"""Locality-adaptive planner: the HTM_SWITCH equivalent.

Counterpart of ``htm_hashjoin_tpu/joins/adaptive.py``.  With HTM_SWITCH
(config.h:16-17) the reference's pre-pass inserts K=5 rounds of 16384
tuples per partition under HTM and measures firstRoundFailureFraction
(HTMHashBuild.hpp:47-52,100-154); a high abort rate means no locality, and
the driver switches from the HTM build to the radix join, the paper's
headline mechanism (README.md:6).

The sniff samples strided chunks across the relation and measures what
makes the HTM path the wrong plan: duplicate keys and a key universe that
is not dense.  The thresholds are the reference's adaptive ones
(HTMHashBuild.hpp:204-211):

  dup_fraction < 0.004 and max_key <= 3 * numBuckets  ->  HTM path
  otherwise                                          ->  radix path
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import JoinConfig
from ..relation import Relation
from ..utils.metrics import JoinMetrics
from ..utils.timing import PhaseTimer
from .common import htm_num_buckets
from .htm import htm_join
from .radix import radix_join

SNIFF_TARGET = 1 << 20  # total sniff sample size cap


def _sniff(keys: torch.Tensor, num_partitions: int, chunk: int):
    """The first ``chunk`` keys of each of num_partitions static ranges
    (HTMHashBuild.hpp:100-148 sampling shape) -> [adjacent duplicates in
    the sorted sample, max key] (int64, on the keys' device)."""
    n = keys.numel()
    part = max(1, n // num_partitions)
    starts = torch.arange(num_partitions, device=keys.device) * part
    offs = torch.arange(min(chunk, part), device=keys.device)
    idx = (starts[:, None] + offs[None, :]).reshape(-1)
    sample = keys[idx.clamp_(0, n - 1)]
    s = torch.sort(sample).values
    return torch.stack([(s[1:] == s[:-1]).sum(),
                        sample.amax().to(torch.int64)])


def sniff_statistics(keys: torch.Tensor, cfg: JoinConfig, timer: PhaseTimer):
    """(duplicate fraction, max key) of the sniff sample, in one readback.
    The fraction is the float32 mean of the JAX package, taken on the
    host from the exact counts."""
    chunk = min(cfg.sniff_rounds * cfg.sniff_chunk,
                max(1, SNIFF_TARGET // max(1, cfg.num_partitions)))
    dups, max_key = timer.timed(
        "sniff", _sniff, keys, cfg.num_partitions, chunk).tolist()
    part = max(1, keys.numel() // cfg.num_partitions)
    pairs = cfg.num_partitions * min(chunk, part) - 1
    dup_frac = np.float32(dups) / np.float32(pairs) if pairs else np.nan
    return float(dup_frac), int(max_key)


def adaptive_join(r: Relation, s: Optional[Relation] = None,
                  cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    timer = PhaseTimer()
    dup_frac, max_key = sniff_statistics(r.keys, cfg, timer)
    dense = max_key <= 3 * htm_num_buckets(cfg.r_size)
    use_htm = dup_frac < 0.004 and dense
    m = (htm_join if use_htm else radix_join)(r, s, cfg)
    m.algo = "adaptive"
    m.firstRoundTime = timer.micros.get("sniff", 0.0)
    m.firstRoundFailureFraction = dup_frac
    m.extra["chosenPath"] = "htm" if use_htm else "radix"
    m.extra["sniffMaxKey"] = max_key
    m.extra["sniffDense"] = bool(dense)
    return m
