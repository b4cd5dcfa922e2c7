"""Parallel radix join: the PRO / PRJ equivalent.

Counterpart of ``htm_hashjoin_tpu/joins/radix.py`` (reference
mc/src/parallel_radix_join.c:231-1309).  Three routes, as in the JAX
package:

  * ``radix_strategy="multipass"`` (the CLI's ``--radixStrategy
    multipass``): the real fanout-bounded multi-pass partition
    (``ops/radix_kernels.py``: K2 + K6 a pass), a final tile sort (K2, the
    per-partition build), and the banded probe (K4; K3 first for an
    unsorted probe side);
  * the engine sort plan, for keys below PACK_LIMIT: ``common.engine_join``
    with the global sort first (K3, then K4/K5) when S is larger than a
    tile;
  * the sort route, for wider keys (the random distribution) or the
    ``xla`` backend: one int32 key sort (K3 at n >= 2^17 unless the backend
    is ``xla``, ``torch.sort`` otherwise) is the MSB partition and the
    per-partition search structure; the probe is ``probe_sorted``.

The reference fork's PRO measures partition+build only (its probe loop is
commented out, parallel_radix_join.c:262-276); here the probe is run and
timed too, and partition/build/probe are reported separately.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..config import JoinConfig
from ..ops import partition, probe
from ..ops.radix_kernels import multipass_radix_partition
from ..ops.sort_tiles import sort_tiles
from ..relation import Relation
from ..utils.metrics import JoinMetrics
from ..utils.profiler import span
from ..utils.timing import PhaseTimer, fence_outputs, readback
from .banded_backend import (DEFAULT_TILE, BandedBuild, _key_sum,
                             banded_probe, k3_sort, sort_probe_side)
from .common import (BandedPlan, _build_key_bound, _max_key_bound,
                     engine_join, finish_metrics, join_scope, probes,
                     resolve_relations, use_pallas_engine)

# The multipass tile below 2^17 keys.  The JAX package takes 1024 there;
# the port's count kernels need a tile larger than their 1024-key overhang
# (K4/K5 take 2048 and up), so the port takes 2048.
SMALL_TILE = 2048


def _msb_stats(sorted_keys: torch.Tensor, bits: int):
    res, _shift = partition.radix_partition_msb(sorted_keys, bits,
                                                sorter=lambda k: k)
    return (res.hist, torch.sum(sorted_keys, dtype=torch.int64),
            res.hist.amax())


def _partition_build(keys: torch.Tensor, bits: int, use_megakernel: bool):
    """MSB radix partition + build: one int32 key sort (see
    ``radix_partition_msb``).  The sorted array is both the partitioned
    layout and every partition's search structure."""
    if use_megakernel:
        sorted_r = k3_sort(keys)
    else:
        sorted_r = torch.sort(keys).values
    hist, ksum, max_part = _msb_stats(sorted_r, bits)
    return sorted_r, hist, ksum, max_part


def _probe(sorted_r: torch.Tensor, skeys: torch.Tensor) -> torch.Tensor:
    # equal keys <=> equal partitions and slots under MSB digits, so the
    # count runs on raw keys: no (digit << 32 | key) composite
    return probe.probe_sorted(sorted_r, skeys)


def _multipass_radix_join(r: Relation, s: Optional[Relation],
                          cfg: JoinConfig) -> JoinMetrics:
    """The multi-pass fanout-bounded partition engine: radix_bits and
    radix_passes change execution.  Partition -> final tile sort (the
    per-partition build) -> banded probe, timed per phase like the
    reference's partition/build/probe split
    (mc/src/parallel_radix_join.c:1124-1146), each phase in its span
    (``hj.plan`` for the tile and the digits' width, then
    ``hj.partition``, ``hj.build``, ``hj.probe`` and ``hj.line``).

    Only R is partitioned, so the digits are taken over R's key range
    (``_build_key_bound``), not over both sides': with |S| > |R| (PK ⋈ FK
    at Workload A's 2^24 ⋈ 2^28) the wider range would leave the top
    digit bits empty, most partitions without a key and each occupied one
    wider than a tile, so that the build tiles' S bands pass the count's
    chunk limit and flag.  Where |S| <= |R| the range is the same.

    Past the JAX line: ``partitionedKeys``, the keys the last pass wrote,
    padding included (its static size), and ``totalOverflows``, the build
    tiles the probe flagged and the repair recounted (0 without a
    probe)."""
    with span("hj.plan"):
        tile = DEFAULT_TILE if cfg.r_size >= (1 << 17) else SMALL_TILE
        key_bits = max(1, int(_build_key_bound(cfg)).bit_length())
    t0 = time.perf_counter()
    with span("hj.partition"):
        part = multipass_radix_partition(r.keys, radix_bits=cfg.radix_bits,
                                         passes=cfg.radix_passes,
                                         key_bits=key_bits, tile=tile)
        fence_outputs(part.partitioned)  # the partition phase ends here
    t1 = time.perf_counter()
    with span("hj.build"):
        # per-partition build: a tile sort of the value-partitioned stream
        # is every partition's search structure (partitions are
        # value-contiguous)
        sorted_flat, stats = sort_tiles(part.partitioned, tile=tile,
                                        method="bitonic")
        plans, hist_last = part.pass_plans, part.pass_hists[-1]
        partitioned_keys = part.partitioned.numel()
        build = BandedBuild(sorted_flat, stats[:, 0], stats[:, 1], tile,
                            part.n, 0, False)
        del part                          # the pass output (the build's size)
        head = torch.stack([_key_sum(r.keys), _key_sum(sorted_flat),
                            hist_last.amax().to(torch.int64)])
        fence_outputs(head)
    t2 = time.perf_counter()
    matches, overflow = None, 0
    with span("hj.probe"):
        _, skeys = resolve_relations(r, s, cfg)
        if skeys is not None:
            s2d = None
            if not s.assume_sorted:
                skeys, s2d = sort_probe_side(skeys, tile=tile)
            matches, overflow = banded_probe(build, skeys, s2d=s2d)
    t3 = time.perf_counter()
    with span("hj.line"):
        in_sum, out_sum, max_run = readback(head)
        m = JoinMetrics(algo="radix", rSize=cfg.r_size,
                        transactionSize=cfg.transaction_size,
                        probeLength=cfg.probe_length,
                        inputSum=in_sum, outputSum=out_sum,
                        totalOverflows=overflow)
        m.partitionTimeInMicroseconds = (t1 - t0) * 1e6
        m.hashBuildTimeInMicroseconds = (t2 - t0) * 1e6
        if matches is not None:
            m.totalMatches = matches
            m.probeTimeInMicroseconds = (t3 - t2) * 1e6
        m.extra["backend"] = "pallas_multipass_radix"
        m.extra["radixBits"] = cfg.radix_bits
        m.extra["numPasses"] = len(plans)
        m.extra["passBits"] = [p.bits for p in plans]
        m.extra["passShifts"] = [p.shift for p in plans]
        m.extra["fanout"] = 1 << cfg.radix_bits
        m.extra["maxRunSize"] = max_run
        m.extra["partitionedKeys"] = partitioned_keys
        if m.rSize:
            m.failedTransactionPercentage = 0.0
            m.totalFailedPercentage = 0.0
    return m


@join_scope
def radix_join(r: Relation, s: Optional[Relation] = None,
               cfg: JoinConfig = JoinConfig()) -> JoinMetrics:
    """Radix join with cfg.radix_bits total fanout bits (NUM_RADIX_BITS=14,
    mc/src/prj_params.h:15-22), MSB digit convention (Wisconsin's
    RadixPartitioner, partitioner.cpp:443-520).

    ``radix_strategy="multipass"`` runs the fanout-bounded multi-pass
    partition engine; "sort"/"auto" run the global-sort plans."""
    with span("hj.plan"):
        # the banded probe counts keys below PACK_LIMIT only: wider keys
        # take the sort route below; build-only partitions any int32
        multipass = (cfg.radix_strategy == "multipass"
                     and cfg.backend != "xla"
                     and (not probes(s, cfg)
                          or _max_key_bound(cfg) < (1 << 29)))
        engine = not multipass and use_pallas_engine(cfg, s)
        # the global sort exists only to keep every tile's S band narrow;
        # a probe side within one tile bounds every band by |S| (the
        # reference's PRO benchmark shape, --s-size=2, motivation.sh:11)
        presort = engine and s.keys.numel() > DEFAULT_TILE
    if multipass:
        return _multipass_radix_join(r, s, cfg)
    if engine:
        def fields(m: JoinMetrics) -> None:
            m.partitionTimeInMicroseconds = m.hashBuildTimeInMicroseconds
            m.extra["radixBits"] = cfg.radix_bits
            m.extra["numPasses"] = cfg.radix_passes

        return engine_join("radix", r, s, cfg,
                           BandedPlan(None, presort, False, None), fields)
    rkeys, skeys = resolve_relations(r, s, cfg)
    use_mk = cfg.backend != "xla" and rkeys.numel() >= (1 << 17)
    timer = PhaseTimer()
    sorted_r, hist, in_sum, max_part = timer.timed(
        "build", _partition_build, rkeys, cfg.radix_bits, use_mk)
    matches = None
    if skeys is not None:
        matches = timer.timed("probe", _probe, sorted_r, skeys)
    single_us = None
    if cfg.pipeline_depth > 1 and skeys is None:
        # sustained shape of the build-only partition rows (the reference
        # PRO benchmark, --s-size=2 / no probe): K partitions, one fence
        t0 = time.perf_counter()
        for _ in range(cfg.pipeline_depth):
            res = _partition_build(rkeys, cfg.radix_bits, use_mk)
        readback(res[2])
        per_point = (time.perf_counter() - t0) * 1e6 / cfg.pipeline_depth
        single_us = timer.micros.get("build", 0.0)
        timer.micros["build"] = per_point
    avg = max(1, cfg.r_size >> cfg.radix_bits)
    head = [in_sum, max_part.to(torch.int64), (hist > 4 * avg).sum()]
    if matches is not None:
        head.append(matches)
    head = readback(torch.stack(head))              # the one readback
    m = JoinMetrics(algo="radix", rSize=cfg.r_size,
                    transactionSize=cfg.transaction_size,
                    probeLength=cfg.probe_length,
                    inputSum=head[0], outputSum=head[0])
    if single_us is not None:
        m.extra["singleRunTimeInMicroseconds"] = single_us
        m.extra["pipelineDepth"] = cfg.pipeline_depth
    m.partitionTimeInMicroseconds = timer.micros.get("build", 0.0)
    m.extra["radixBits"] = cfg.radix_bits
    m.extra["numPasses"] = cfg.radix_passes
    m.extra["fanout"] = 1 << cfg.radix_bits
    m.extra["maxPartitionSize"] = head[1]
    m.extra["skewedPartitions"] = head[2]
    return finish_metrics(m, timer, head[3] if matches is not None else None)
