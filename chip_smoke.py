#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (htm_hashjoin_tpu_torch) on one GPU.

Phases, one line each:
  1. device   - the card's name and power limit (nvidia-smi);
  2. build    - nvcc builds the kernels from htm_hashjoin_tpu_torch/csrc/
                (one nvcc process per source, all started together); each
                kernel's registers and spill bytes as ptxas reports them
                (K7a's kernels must not spill);
  3. kernel   - K1 (fused_sort_count) against its plain torch version on
                the card, on cases of a few tiles, exactly (integer outputs;
                counts only on tiles with zero inversions); K1 and K5 on the
                register count's edge kinds (duplicate runs across threads
                and warps, a run in the overhang, keys at PACK_LIMIT and
                above, negatives with INT32_MIN, a tile of MAXI32 only, an
                odd-even sort with too few passes, a 6000-copy S run) and
                K1's band prepass (tile_minmax, padding tiles included)
                against theirs, exactly; then K2 (all four
                sorters, blocks of 2, 32 and 2048 keys, on negatives with
                INT32_MIN and a tile of MAXI32 only too), K3 (the radix sort,
                on negatives with INT32_MIN, constant and two-valued keys
                too), K4 (bands of 0, 1 and many chunks, a band past the end
                of S, the 2^37-pair heavy hitter, and hot keys over many
                chunks: one key, two keys meeting inside a chunk, a run
                ending mid-chunk, a tile of 2^14 chunks) and K5 against
                theirs, exactly; K3 and K7 at 2^29 + 1 keys and pairs, past
                the old 2^30-key cap, exactly, then freed;
  4. main     - the headline join, 2^27 locality build + 2^27 sorted probe,
                through banded_join_pipelined with bench.py's asserts and a
                count of K1 and prepass launches; then the abort -> bitonic
                retry at 2^24;
  5. times    - K1 ("blocks" w16, and "bitonic" as the retry runs it) and
                the prepass against their plain versions at 2^27 (held equal
                there too); the device chain of one enqueue_banded_join,
                timed, and split by one torch.profiler call into the
                prepass, the searchsorted calls, K1 and the rest (no op but
                the prepass and K1 may take 0.1 ms: one read of R takes
                0.16); sustained (5 joins per readback) and single-run
                throughput;
  6. path     - every other plan once at 2^27 keys a side (the heavy hitter
                at 2^24): build-only with and without locality, wide band,
                sort-first, the sort-first switch, the skewed probe with its
                repair, the heavy hitter's in-place recount; exact answers,
                each kernel's launches (counts set to 0 just before each
                path, read just after), the wall time and the peak device
                memory;
     profile  - each path that sorts with K2, K3 or K7 or counts with K4
                (here, the multipass joins, in the CLI phase with its
                relations already on the card, and once per Wisconsin conf
                that splits) again: walls, then one call under
                torch.profiler (busy, its largest kernels, idle share);
  7. kernel times - K2-K5 at their paths' shapes against their plain
                versions (held equal there too) and, for K2 and K3, against
                one torch.sort call; K4 also at the skewed probe's repair
                shape (printed, not reported);
  8. radix      - K6 against its plain version on cases of a few tiles
                (fanout 128 at tile 8192, empty runs, runs of many rows,
                three passes), exactly; the multipass radix join at 2^27
                (pk R x sorted S, 14 bits in two passes of 7) through
                radix_join, exact, with two K6 launches and its peak device
                memory, then build-only; K6 against its plain version at the
                2^27 pass-1 and pass-2 shapes, timed; K2 at the join's final
                sort, on K6's pass-2 output (printed, not reported);
  9. cli        - the CLI in-process (cli.main) at --rSize 2^27, one line per
                path the planner chooses: adaptive -> htm (K1), adaptive ->
                radix on the engine's sort plan and on the sort route (held
                to a torch.unique count), mc PRO (PK x FK), htm --switchSniff
                -> radix; each line's counts, sums, path and kernels checked;
 10. hash       - the claim-round kernel (csrc/claim_insert.cu) against
                its plain version (the torch claim rounds) on duplicates
                with key 0 at budgets 1, 4 and 6, exactly, then at the hash
                cell's build (2^27 shuffled keys into 2^28 slots) at budgets
                4 (reported) and 6, held equal and timed, and split by
                launch under the profiler; the table-probe kernel
                (csrc/hash_probe.cu) against its plain version (the torch
                gathers) at the hash cell's probe (2^27 sorted S into that
                table at budget 4; reported), on a shuffled S and on npo's
                and htm's bucket tables, held equal and timed, and split
                under the profiler; the hash-table
                joins and sortmerge: at 2^22 through
                DISPATCH, nocc, atomic and htm with --backend xla on
                sorted, shuffle and uniform keys (2^20 distinct), build-only
                and probing, npo_st on PK x FK and nocc on random keys, each
                line equal to the same call's line on the CPU but for the
                times; then at 2^27 through cli.main the reference's own
                points: AtomicsVsHTMVsNoCC (nocc, atomic, htm x sorted,
                shuffle, build-only, no retry, --backend xla), probe.sh's
                first point (local_shuffle w16, --backend xla), duplicates
                (uniform, 2^24 distinct), mc NPO (the engine) and NPO_st
                (the bucket build), sortmerge on shuffle (K3 + K5) and on
                random (the plain route), atomic on auto (the engine); each
                line held to an exact count (n, the s-size, or a
                torch.unique count), conservation (nocc: outputSum and
                matches at most the exact ones), zero conflicts on unique
                keys and the plan's launches of every kernel (one claim
                kernel build on each scatter build but nocc's and htm's
                without retry, one probe kernel launch on each scatter
                join that probes), with a profile of each scatter-build
                path;
 11. wisconsin  - K7 (the key-value radix sort) against its plain version
                (stable sort + gather) on few-tile cases (one tile, two, 2^3
                padded, 16 copies a key, rotation-packed keys with shard
                bits, negatives, two values), exactly; K7a (the TPU's phase
                A, on no path now) alone against its plain version, bit for
                bit, at every kernel tile in both directions (all keys
                equal, sorted, reversed, 16 copies a key, MAXI32 padding in
                the last block, INT32_MIN and negatives; one tile and 64);
                the six shipped multijoin
                confs at the reference's 2^24 PK build x 2^28 FK probe
                through run_multijoin, each run twice and the second reported
                (JSON line, K7 launches, peak device memory), its output held
                as a multiset of (build rid, probe rid) pairs to a plain torch
                join of the same tables, K7 launched on every conf but
                no_partition; then K7 (exactly, and against the stable sort +
                gather) and K7a against their plain versions at the probe
                split's shape (2^28 rotation-packed keys plus payload),
                timed, and K7a's library call (a per-block torch.sort and a
                gather of the values); K7a also in its smaller blocks there
                (exact; times printed, not reported);
 12. measure    - the measurement layer: the testbed's 2^27 copy rate (at
                most 3.35 TB/s + 5 %); cli.main with --counters
                --throughput on the headline join (--algo htm) and on the
                atomic scatter build (--backend xla --noProbe, shuffled),
                each line's default events, its bandwidth at most the copy
                rate + 5 % and tuplesPerSecond = n / time; --profile on the
                headline join, its Chrome trace naming
                fused_sort_count_kernel; the harness's probe grid (84
                points, --pipelineDepth 5: K1, K2 + K4, K3 + K5) and
                skewprobe grid (15) at 2^27 into a temporary --outDir,
                every line exact against two torch.searchsorted calls on
                the same relations, the clean probe lines sustained, the
                logs written; the chunk sweep at 2^27 (chunks 2^0..2^12)
                and at 2^20 equal to the CPU's rows but for the time; a
                2^24 relation through .npz and back, and the read-through
                cache; the native generator's 2^27 keys (when its library
                loads and runs on this host) through the headline join;
 13. distributed - the distributed join, eight shards on the card (a
                device-mapping file names cuda:0 eight times, for this phase
                only; the shards run one after another): cli.main
                --meshShape 8 and 2,4 on 2^27 shuffled keys (exact, no
                drops or repairs); --skewHandling on zipf(1.2) R over 2^23
                keys (exact against a plain count, hot keys found); the
                forced repair (capacity 1.0) on (8,) and (2, 4), exact with
                no drops; drops without the repair; a (1,) mesh without the
                mapping equal to the single-device radix join; a profile of
                the flat, skew-plan and repair cases and scaling_point's
                exchange / join / repair split at 2^27; the four
                configurations at 2^20, the card's lines equal to the
                CPU's; reference fault 9 at
                2^22 (R key 0, S key INT32_MAX) exact; dryrun_multichip(8);
                the scaling sweep at its defaults, every point exact;
 14. experiments - entry() (the single-device entry step: one claim
                kernel build, its retry rounds, and one probe kernel
                launch) on the
                card equal to the CPU's and to (2^16, 2^16 (2^16 + 1) / 2, 0),
                and
                ``python -m htm_hashjoin_tpu_torch.entry``'s main; the
                adaptive dial experiment at its defaults (2^26, each plan's
                warm median and launches, every rep exact; whether adaptive
                beats both fixed plans is printed); the radix crossover at
                its defaults (2^20..2^27, both engines' outputs held as
                multisets and to their order; multipass/sort per size); the
                eight reference grids no other phase runs at 2^27, one rep
                each, every line conserving its key sum (and exact where it
                probes) and each grid's kernels launched; then the source
                paper's motivation comparison per locality window, PRO's
                build time against the adaptive HTM build's (printed, not
                required).
Then a JSON line of kernels (launches on the paths, largest error, the
kernel's, its plain version's and a library call's time, and its bound: the
bytes of its inputs and outputs over 3.35 TB/s; K7a, which no path runs,
has 0 launches there and its kernel phase's launches apart, as
kernel_phase_launches) and, last, {"ok": true, "device": {...}}.
Any failure raises: the script exits non-zero and prints no result.  With no
CUDA device it exits 1 at once.  Every 2^27 input is freed before the next
is made.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import gzip
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from htm_hashjoin_tpu_torch import bench, cli
from htm_hashjoin_tpu_torch.benchmarks import chunk_sweep, memory_bandwidth
from htm_hashjoin_tpu_torch.config import Algo, Distribution, JoinConfig
from htm_hashjoin_tpu_torch.constants import MAXI32
from htm_hashjoin_tpu_torch.data import native, persist
from htm_hashjoin_tpu_torch.data.generators import (build_relations,
                                                    local_shuffled_keys,
                                                    pk_keys, shuffled_keys,
                                                    sorted_keys, zipf_keys)
from htm_hashjoin_tpu_torch.entry import entry
from htm_hashjoin_tpu_torch.entry import main as entry_main
from htm_hashjoin_tpu_torch.experiments import adaptive_dial_bench as dial
from htm_hashjoin_tpu_torch.experiments import kernel_launches
from htm_hashjoin_tpu_torch.experiments import radix_crossover as rx
from htm_hashjoin_tpu_torch.harness import GRIDS, report, run_grid, runner
from htm_hashjoin_tpu_torch.joins import DISPATCH
from htm_hashjoin_tpu_torch.joins import banded_backend as bb
from htm_hashjoin_tpu_torch.joins.common import htm_num_buckets
from htm_hashjoin_tpu_torch.joins.radix import radix_join
from htm_hashjoin_tpu_torch.ops import _build
from htm_hashjoin_tpu_torch.ops import banded_count as bc
from htm_hashjoin_tpu_torch.ops import banded_count_narrow as bcn
from htm_hashjoin_tpu_torch.ops import fused_sort_count as fsc
from htm_hashjoin_tpu_torch.ops import global_sort as gs
from htm_hashjoin_tpu_torch.ops import global_sort_kv as gkv
from htm_hashjoin_tpu_torch.ops import insert, probe
from htm_hashjoin_tpu_torch.ops import radix_kernels as rk
from htm_hashjoin_tpu_torch.ops import scatter_tiles as sct
from htm_hashjoin_tpu_torch.ops import sort_kv_tiles as skv
from htm_hashjoin_tpu_torch.ops import sort_tiles as st
from htm_hashjoin_tpu_torch.ops import tile_minmax as tmm
from htm_hashjoin_tpu_torch.ops.hashing import identity_hash, locality_hash
from htm_hashjoin_tpu_torch.parallel import scaling
from htm_hashjoin_tpu_torch.parallel.dist_join import distributed_join
from htm_hashjoin_tpu_torch.parallel.dryrun import dryrun_multichip
from htm_hashjoin_tpu_torch.parallel.mesh import mapping_env
from htm_hashjoin_tpu_torch.relation import Relation
from htm_hashjoin_tpu_torch.utils.profiler import tensor_bytes
from htm_hashjoin_tpu_torch.wisconsin import (CONF_DIR, parse_conf,
                                           run_multijoin)
from htm_hashjoin_tpu_torch.wisconsin import partitioner as wpart
from htm_hashjoin_tpu_torch.wisconsin.driver import load_side

TILE = 8192
LOG2_N = 27
HASH_LOG2_N = 22      # the scatter builds held to the CPU's lines
WINDOW = 16
CSRC = "htm_hashjoin_tpu_torch/csrc/"
JOIN_KERNELS = "htm_hashjoin_tpu/ops/pallas/join_kernels.py"
RADIX_KERNELS = "htm_hashjoin_tpu/ops/pallas/radix_kernels.py"
# name -> (wrapper module, CUDA source, the TPU kernel's pallas_call)
KERNELS = {
    "fused_sort_count": (fsc, "fused_sort_count.cu", f"{JOIN_KERNELS}:1068"),
    "sort_tiles": (st, "sort_tiles.cu", f"{JOIN_KERNELS}:238"),
    "global_sort_tiles": (gs, "radix_sort.cu", f"{JOIN_KERNELS}:429"),
    "banded_count": (bc, "banded_count.cu", f"{JOIN_KERNELS}:1240"),
    "banded_count_narrow": (bcn, "banded_count_narrow.cu",
                            f"{JOIN_KERNELS}:889"),
    "scatter_tiles": (sct, "scatter_tiles.cu", f"{RADIX_KERNELS}:348"),
    "sort_kv_tiles": (skv, "sort_kv_tiles.cu", f"{JOIN_KERNELS}:561"),
    "global_sort_kv_tiles": (gkv, "radix_sort.cu", f"{JOIN_KERNELS}:701"),
    "claim_insert": (insert, "claim_insert.cu", "none: XLA scatter"),
    "hash_probe": (probe, "hash_probe.cu", "none: XLA gathers"),
}
# kernels on no path, each with the reason: held to their plain versions
# and timed, but exempt from the check that a path launched them
OFF_PATH = {"sort_kv_tiles": "the radix sort behind K7 needs no phase A"}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory, NVIDIA's data sheet
# the harness grids of the measurement phase: (pipeline depth, the kernels
# each grid's plans must launch)
HARNESS = {"probe": (5, {"fused_sort_count": 1, "sort_tiles": 1,
                         "banded_count": 1, "global_sort_tiles": 1,
                         "banded_count_narrow": 1}),
           "skewprobe": (1, {"global_sort_tiles": 1, "banded_count": 1})}
# the eight reference grids no other phase runs, for the experiments
# phase: every point builds only; the builds sort tiles (K2) but on sorted
# keys (presorted: no kernel), and PRO's partition sorts globally (K3)
GRIDS_BUILD = {name: (1, expect) for name, expect in (
    ("AtomicsVsHTMVsNoCC", {"sort_tiles": 1}),
    ("SizeToAbortsAndTimeSorted", {}),
    ("SizeToAbortsAndTimeShuffled", {"sort_tiles": 1}),
    ("TSizeAndShuffleWindowstoTime", {"sort_tiles": 1}),
    ("adaptive", {"sort_tiles": 1}), ("adaptive2", {"sort_tiles": 1}),
    ("motivation", {"sort_tiles": 1, "global_sort_tiles": 1}),
    ("track", {"sort_tiles": 1}))}
# the port's own copies of the six shipped confs, found from its package path
WISCONSIN_CONFS = os.path.join(CONF_DIR, "")
# conf -> whether its splits sort through K7: every conf's hash node is a
# ModuloHash over two int32 columns of 2^24 and 2^28 rows, so a side whose
# partitioner hashes takes the kv split (partitioner.py:236-259)
CONFS = {"no_partition": False, "independent": True, "parallel": True,
         "radix1": True, "steal": True, "flatmem": True}


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _smi(fields: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _max_abs_err(kernel_out, plain_out) -> int:
    """K1's largest absolute difference from its plain version over sorted
    keys, stats, flags and both key sums, and over counts of tiles the
    sorter left without inversions (counts are defined only there)."""
    exact = plain_out[1][:, 2] == 0
    diffs = [(g.long() - w.long()).abs()
             for k, (g, w) in enumerate(zip(kernel_out, plain_out)) if k != 2]
    diffs.append(torch.where(exact, (kernel_out[2] - plain_out[2]).abs(), 0))
    return max(int(d.max()) if d.numel() else 0 for d in diffs)


def _check_kernel(name, rkeys, skeys, method, passes):
    r_flat = bb.to_tiles(rkeys, TILE)
    s_pad = bb.prepare_probe_side(skeys, TILE)
    _, _, row_off, rows_needed = bb.band_rows(r_flat, skeys, TILE)
    args = (r_flat, s_pad, row_off, rows_needed)
    kw = dict(tile=TILE, method=method, passes=passes)
    got = fsc.fused_sort_count(*args, **kw)
    torch.cuda.synchronize()
    want = fsc.fused_sort_count_ref(*args, **kw)
    err = _max_abs_err(got, want)
    viols = int(want[1][:, 2].sum())
    flagged = int(want[3].sum())
    print(f"kernel: {name}: {r_flat.numel() // TILE} tiles, method={method} "
          f"passes={passes}, inversions={viols}, flagged={flagged}, "
          f"matches={int(want[2].sum())}, max_abs_err={err}")
    _require(not err, f"K1 differs from its plain version on {name}")
    return err, viols, flagged


K1_KINDS = ("duplicate runs across threads and warps",
            "a run in the last OV keys and the overhang",
            "keys at PACK_LIMIT and above", "negatives and INT32_MIN",
            "a tile of MAXI32 only", "oddeven with too few passes",
            "a 6000-copy S run")


def _k1_kind(kind, dev):
    """(unsorted R, sorted S, method, passes) of 4 tiles: the register
    count's edges (the same kinds as tests/test_torch_cuda.py)."""
    n = 4 * TILE
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    keys = torch.arange(1, n + 1, dtype=torch.int32, device=dev)

    def shuffle(x, window):
        jitter = torch.randint(0, window, (x.numel(),), generator=gen,
                               device=dev)
        return x[torch.sort(torch.arange(x.numel(), device=dev) + jitter,
                            stable=True).indices]

    def run(count, key):
        return torch.full((count,), key, dtype=torch.int32, device=dev)

    if kind == K1_KINDS[0]:   # runs of 1-11; 300 copies over a warp's 512
        r = torch.repeat_interleave(keys, torch.randint(
            1, 12, (n,), generator=gen, device=dev))[:n].clone()
        r[512 - 150:512 + 150] = r[512 - 150]
        s = torch.cat([torch.arange(1, int(r.max()) + 1, dtype=torch.int32,
                                    device=dev), r[::3]])
        return shuffle(r, 8), torch.sort(s).values, "blocks", 8
    if kind == K1_KINDS[1]:   # S's 257 copies straddle band position T
        r, extra = keys.clone(), []
        for t in range(4):
            k = int(r[t * TILE + TILE - 100])
            r[t * TILE + TILE - 110:t * TILE + TILE - 90] = k
            extra.append(run(256, k))
        return (shuffle(r, 16), torch.sort(torch.cat([keys] + extra)).values,
                "blocks", 16)
    if kind == K1_KINDS[2]:
        high = torch.cat([(1 << 29) + torch.arange(400, device=dev),
                          run(100, MAXI32 - 1)]).to(torch.int32)
        r = torch.sort(torch.cat([keys[:n - 500], high])).values
        return (shuffle(r, 4), torch.sort(torch.cat([r, high])).values,
                "oddeven", 4)
    if kind == K1_KINDS[3]:
        r = torch.sort(_full_range(n, dev, 33)).values
        r[:50] = -2**31
        s = torch.sort(torch.cat([r[::2], run(30, -2**31)])).values
        return shuffle(r, 512), s, "bitonic", 1
    if kind == K1_KINDS[4]:
        r = shuffle(keys, 16)
        r[TILE:2 * TILE] = MAXI32
        return r, keys, "blocks", 16
    if kind == K1_KINDS[5]:
        return shuffle(keys, 64), keys, "oddeven", 1
    return (shuffle(keys, 8), torch.sort(torch.cat([keys, run(6000, 100)])
                                         ).values, "oddeven", 8)


def _check_k1_kinds(dev, errs) -> None:
    """K1 on each kind's unsorted tiles and K5 on the same tiles sorted,
    each against its plain version, exactly (K1's counts where its tile has
    no inversions); then the prepass against its plain version on the
    kinds' tiles, a padded last tile and tiles of MAXI32 only."""
    for kind in K1_KINDS:
        rkeys, skeys, method, passes = _k1_kind(kind, dev)
        r_flat = bb.to_tiles(rkeys, TILE)
        s_pad = bb.prepare_probe_side(skeys, TILE)
        _, _, row_off, rows_needed = bb.band_rows(r_flat, skeys, TILE)
        args = (r_flat, s_pad, row_off, rows_needed)
        kw = dict(tile=TILE, method=method, passes=passes)
        got = fsc.fused_sort_count(*args, **kw)
        torch.cuda.synchronize()
        want = fsc.fused_sort_count_ref(*args, **kw)
        err = _max_abs_err(got, want)
        viols = int(want[1][:, 2].sum())
        sorted_r = torch.sort(r_flat.view(-1, TILE), dim=1).values.reshape(-1)
        got5 = bcn.banded_count_narrow(sorted_r, *args[1:], tile=TILE)
        want5 = bcn.banded_count_narrow_ref(sorted_r, *args[1:], tile=TILE)
        err5 = max(_err(g, w) for g, w in zip(got5, want5))
        print(f"kernel: K1 and K5 on {kind}: method={method} passes={passes},"
              f" inversions={viols}, flags={want[3].tolist()}, matches="
              f"{int(want5[0].sum())}, max_abs_err={err} (K5: {err5})")
        _require(not err and not err5 and
                 (viols > 0) == (kind == K1_KINDS[5]) and
                 (int(want[3][0]) == 1) == (kind == K1_KINDS[6]),
                 f"K1 or K5 differs from its plain version on {kind}")
        errs["fused_sort_count"] = max(errs["fused_sort_count"], err)
        errs["banded_count_narrow"] = max(errs["banded_count_narrow"], err5)
    keys = bb.to_tiles(_full_range(5 * TILE - 777, dev, 34), TILE)
    keys[TILE:2 * TILE] = MAXI32
    for what, r in (("negatives, a padded last tile, a tile of MAXI32 only",
                     keys), ("MAXI32 only", torch.full_like(keys, MAXI32)),
                    ("one tile", keys[:TILE].clone())):
        got = tmm.tile_minmax(r, TILE)
        want = tmm.tile_minmax_ref(r, TILE)
        err = max(_err(got[0], want[0]), _err(got[1], want[1]))
        print(f"kernel: prepass tile_minmax on {what}: max_abs_err={err}")
        _require(not err, f"the prepass differs from its plain version on "
                 f"{what}")


def _events_ms(fn, reps: int) -> float:
    fn()                                   # warm-up
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bound_ms(inputs, outputs) -> float:
    """The least time the card could take: each input byte read once and
    each output byte written once at the device-memory rate (no kernel
    here does arithmetic worth a bound of its own)."""
    return tensor_bytes(inputs, outputs) / HBM_BYTES_PER_S * 1e3


def _reset_counts() -> None:
    for mod, _, _ in KERNELS.values():
        mod.LAUNCHES = 0
    tmm.LAUNCHES = 0


def _counts() -> dict:
    return kernel_launches()


def _err(got, want) -> int:
    """Largest absolute difference of two integer tensors (0 if equal)."""
    _require(got.shape == want.shape, f"shape {tuple(got.shape)} != "
             f"{tuple(want.shape)}")
    if torch.equal(got, want):
        return 0
    return int((got.long() - want.long()).abs().max())


def _duplicates(n, dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randint(1, n // 7, (n,), generator=gen, device=dev,
                         dtype=torch.int32)


def _full_range(n, dev, seed):
    """Keys over the whole int32 range, every 97th INT32_MIN."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    keys = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    keys[::97] = -2**31
    return keys


def _count_inputs(dev, n_tiles=6):
    """Sorted tiles of duplicate keys (the last one padded) against a sorted
    S with a run of 3 tiles of one key: bands of 0, 1 and many chunks."""
    r = torch.sort(_duplicates(n_tiles * TILE - 300, dev, 3)).values
    s = torch.sort(torch.cat([_duplicates(n_tiles * TILE, dev, 4),
                              torch.full((3 * TILE,), 5, dtype=torch.int32,
                                         device=dev)])).values
    r_flat = bb.to_tiles(r, TILE)
    mins, maxs, _ = st.tile_stats(r_flat, TILE)
    row_off, rows_needed = bb._rows(*bb._slice_offsets(s, mins, maxs))
    return r_flat, bb.prepare_probe_side(s, TILE), row_off, rows_needed


def _check_other_kernels(dev, errs: dict) -> None:
    """K2 (four sorters), K3, K4 and K5 against their plain versions on
    cases of a few tiles, exactly."""
    n = 3 * TILE - 77
    padding = local_shuffled_keys(n, 64, 6, dev)
    padding[TILE:2 * TILE] = MAXI32
    cases = {"displaced w64, padded last tile":
             bb.to_tiles(local_shuffled_keys(n, 64, 5, dev), TILE),
             "duplicates, padded last tile":
             bb.to_tiles(_duplicates(n, dev, 1), TILE),
             "negatives and INT32_MIN, padded last tile":
             bb.to_tiles(_full_range(n, dev, 7), TILE),
             "a tile of MAXI32 only": bb.to_tiles(padding, TILE)}
    for case, keys in cases.items():
        for method, passes in (("bitonic", 1), ("bitonic_alt", 1),
                               ("blocks", 16), ("oddeven", 4), ("blocks", 1),
                               ("blocks", 600)):
            kw = dict(tile=TILE, method=method, passes=passes)
            got = st.sort_tiles(keys, **kw)
            want = st.sort_tiles_ref(keys, **kw)
            err = max(_err(got[0], want[0]), _err(got[1], want[1]))
            errs["sort_tiles"] = max(errs["sort_tiles"], err)
            print(f"kernel: K2 {method} passes={passes} on {case}: inversions="
                  f"{int(want[1][:, 2].sum())}, max_abs_err={err}")
            _require(not err, f"K2 {method} differs from its plain version")
    for n in (4 * TILE + 77, (1 << 20) + 5):
        wide = _full_range(n, dev, 3)
        for kind, keys in (("permutation", shuffled_keys(n, 1, dev)),
                           ("duplicates", _duplicates(n, dev, 2)),
                           ("negatives and INT32_MIN", wide),
                           ("all equal", torch.full_like(wide, -7)),
                           ("two values", torch.where(wide < 0, 3, -5)
                            .to(torch.int32))):
            padded = bb.to_tiles_pow2(keys, TILE)
            err = _err(gs.global_sort_tiles(padded, tile=TILE),
                       gs.global_sort_ref(padded))
            errs["global_sort_tiles"] = max(errs["global_sort_tiles"], err)
            print(f"kernel: K3 on {n} {kind} keys (padded to "
                  f"{padded.numel()}): max_abs_err={err}")
            _require(not err, "K3 differs from torch.sort")

    r_flat, s_pad, row_off, rows_needed = _count_inputs(dev)
    n_chunks = bb._n_chunks(rows_needed, TILE)
    n_chunks[1] = 0
    n_chunks[2] = 1
    got = bc.banded_count(r_flat, s_pad, row_off, n_chunks, tile=TILE)
    want = bc.banded_count_ref(r_flat, s_pad, row_off, n_chunks, tile=TILE)
    err = max(_err(got[0], want[0]), _err(got[1], want[1]))
    print(f"kernel: K4 with n_chunks {n_chunks.tolist()}: matches="
          f"{int(want[0].sum())}, max_abs_err={err}")
    _require(not err and int(n_chunks.max()) > 1,
             "K4 differs from its plain version")
    heavy_r = torch.full((TILE,), 9, dtype=torch.int32, device=dev)
    heavy_s = bb.prepare_probe_side(
        torch.full((1 << 24,), 9, dtype=torch.int32, device=dev), TILE)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    chunks = torch.full((1,), (1 << 24) // TILE, dtype=torch.int32,
                        device=dev)
    got_h = bc.banded_count(heavy_r, heavy_s, zero, chunks, tile=TILE)
    want_h = bc.banded_count_ref(heavy_r, heavy_s, zero, chunks, tile=TILE)
    err_h = max(_err(got_h[0], want_h[0]), _err(got_h[1], want_h[1]))
    print(f"kernel: K4 heavy hitter, {TILE} copies x 2^24 copies: "
          f"{int(got_h[0][0])} (expected {TILE << 24}), max_abs_err={err_h}")
    _require(not err_h and int(got_h[0][0]) == TILE << 24,
             "K4 miscounts the heavy hitter")
    errs["banded_count"] = max(errs["banded_count"], err, err_h)
    del heavy_s
    for kind in HEAVY_BANDS:
        hot_r, hot_s = _heavy_band(kind, dev)
        hot_flat = bb.to_tiles(hot_r, TILE)
        hot_pad = bb.prepare_probe_side(hot_s, TILE)
        mins, maxs, _ = st.tile_stats(hot_flat, TILE)
        offs, rows = bb._rows(*bb._slice_offsets(hot_s, mins, maxs))
        chunks = bb._n_chunks(rows, TILE)
        chunks[7] = 0                             # a tile skipped
        chunks[9] = hot_pad.numel() // TILE + 1   # a band past the end of S
        got = bc.banded_count(hot_flat, hot_pad, offs, chunks, tile=TILE)
        chunks[9] = 0
        want = bc.banded_count_ref(hot_flat, hot_pad, offs, chunks,
                                   tile=TILE)
        status = torch.where(torch.arange(got[1].numel(), device=dev) == 9,
                             2, 0).to(torch.int32)
        err = max(_err(got[0], want[0]), _err(got[1], status))
        errs["banded_count"] = max(errs["banded_count"], err)
        print(f"kernel: K4 on {kind}: {hot_flat.numel() // TILE} tiles, "
              f"chunks up to {int(chunks.max())}, matches="
              f"{int(want[0].sum())}, status {got[1].tolist()[6:11]} (tiles "
              f"6-10), max_abs_err={err}")
        _require(not err, f"K4 differs from its plain version on {kind}")
        del hot_r, hot_s, hot_flat, hot_pad

    args = (r_flat, s_pad, row_off, rows_needed)
    got = bcn.banded_count_narrow(*args, tile=TILE)
    want = bcn.banded_count_narrow_ref(*args, tile=TILE)
    k1 = fsc.fused_sort_count(*args, tile=TILE, method="bitonic")
    err = max(_err(g, w) for g, w in zip(got, want))
    err_k1 = max(_err(got[0], k1[2]), _err(got[1], k1[3]),
                 _err(got[2], k1[4]), _err(got[2], k1[5]))
    print(f"kernel: K5: flagged={int(want[1].sum())}, matches="
          f"{int(want[0].sum())}, max_abs_err={err} (against K1's count: "
          f"{err_k1})")
    _require(not err and not err_k1 and int(want[1].max()) == 1,
             "K5 differs from its plain version or from K1")
    errs["banded_count_narrow"] = max(errs["banded_count_narrow"], err)


HEAVY_BANDS = ("one key over 40 chunks",
               "two hot keys meeting inside a chunk",
               "a run ending mid-chunk into distinct keys",
               "one tile of 2^14 chunks among 64")


def _heavy_band(kind, dev):
    """(sorted R, sorted S) of 64 tiles of unique keys whose bands hold hot
    keys of S (the repair's bands): one key over 40 chunks; two hot keys
    whose runs meet inside a chunk, R holding 32 copies of each; a run
    ending mid-chunk into distinct keys; one tile whose band is 2^14
    chunks."""
    n = 64 * TILE
    r = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    s = [r]

    def run(count, key):
        return torch.full((count,), key, dtype=torch.int32, device=dev)

    if kind == HEAVY_BANDS[0]:
        s.append(run(40 * TILE, 5000))
    elif kind == HEAVY_BANDS[1]:
        r = torch.sort(torch.cat([r[:n - 64], run(32, 5000),
                                  run(32, 5001)])).values
        s += [run(20 * TILE + 3001, 5000), run(9 * TILE + 77, 5001)]
    elif kind == HEAVY_BANDS[2]:
        s.append(run(17 * TILE + TILE // 3, 9000))
    else:
        s.append(run((1 << 14) * TILE, 3 * TILE + 5))
    return r, torch.sort(torch.cat(s)).values


def _check_big_sorts(dev, errs) -> None:
    """K3 and K7 past the old 2^30-key cap: 2^29 + 1 keys (and pairs)
    padded to 2^30, exactly against their plain versions; freed after."""
    n = (1 << 29) + 1
    padded = bb.to_tiles_pow2(_full_range(n, dev, 21), TILE)
    got = gs.global_sort_tiles(padded, tile=TILE)
    err = _err(got, gs.global_sort_ref(padded))
    errs["global_sort_tiles"] = max(errs["global_sort_tiles"], err)
    print(f"kernel: K3 on 2^29 + 1 keys (padded to {padded.numel()}): "
          f"max_abs_err={err}")
    _require(not err, "K3 differs from torch.sort at 2^29 + 1 keys")
    del padded, got
    keys = bb.to_tiles_pow2(_duplicates(n, dev, 22), TILE)
    vals = torch.zeros_like(keys)
    vals[:n] = torch.arange(n, dtype=torch.int32, device=dev)
    got = gkv.global_sort_kv_tiles(keys, vals, tile=TILE)
    want = gkv.global_sort_kv_ref(keys, vals)
    del keys, vals
    err = max(_err(got[0], want[0]), _err(got[1], want[1]))
    errs["global_sort_kv_tiles"] = max(errs["global_sort_kv_tiles"], err)
    print(f"kernel: K7 on 2^29 + 1 pairs (padded to {got[0].numel()}): "
          f"max_abs_err={err}")
    _require(not err, "K7 differs from its plain version at 2^29 + 1 pairs")
    del got, want
    torch.cuda.empty_cache()


def _repair_inputs(r, s):
    """K4's inputs in the skewed probe's batched repair, as
    bb._overflow_tile_matches builds them: the tiles whose bands exceed the
    inline budget, gathered, padded to a power-of-two count and sorted, with
    their unbounded bands in the sorted S."""
    s_sorted, s2d = bb.sort_probe_side(s, TILE)
    r_sorted = gs.global_sort_tiles(bb.to_tiles_pow2(r, TILE), tile=TILE)
    mins, maxs, _ = st.tile_stats(r_sorted, TILE)
    row_off, rows_needed = bb._rows(*bb._slice_offsets(s_sorted, mins, maxs))
    bad = torch.nonzero(bb._n_chunks(rows_needed, TILE)
                        > bb.MAX_CHUNKS_DEFAULT).reshape(-1)
    keys = r_sorted.view(-1, TILE)[bad].reshape(-1)
    bad_sorted = gs.global_sort_tiles(bb.to_tiles_pow2(keys, TILE), tile=TILE)
    mins, maxs, _ = st.tile_stats(bad_sorted, TILE)
    row_off, rows_needed = bb._rows(*bb._slice_offsets(s_sorted, mins, maxs))
    return bad_sorted, s2d, row_off, bb._n_chunks(rows_needed, TILE)


def _run_path(name, fn, expect, card) -> dict:
    """Drive one path with every launch count set to 0 just before it and
    read just after; check its outcome and the kernels it must launch."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"path: {name}: {out}; launches "
          f"{ {k: v for k, v in counts.items() if v} }; wall {wall:.4f} s; "
          f"peak device memory {peak / 2**30:.3f} GiB [{card}]")
    for kernel, least in expect.items():
        _require(counts[kernel] >= least,
                 f"{name} launched {kernel} {counts[kernel]} times, "
                 f"expected at least {least}")
    return counts


def _kernel_name(name: str) -> str:
    """A device event's kernel name without namespaces, template arguments
    and parameters."""
    key = name.replace("(anonymous namespace)::", "")
    key = key.removeprefix("void ").split("(")[0].split("<")[0]
    return key.split("::")[-1]


def _device_ops(fn) -> list:
    """(kernel name, device ms) of every device op of one call of ``fn``
    under torch.profiler, in launch order (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(_kernel_name(e.name), e.device_time / 1e3)
            for e in prof.events() if e.device_type.name == "CUDA"]


# kernels whose device time every profile line gives, in the top four or not
WATCHED = ("sort_tiles_kernel", "banded_count_kernel")


def _profile(name, fn, card, reps=3) -> None:
    """Walls of ``reps`` more calls of a path (each ending in a
    synchronise), then one call under torch.profiler: device busy time (the
    sum of its kernels, fills and copies), the four largest kernels (and
    K2's and K4's, where the call ran them), and
    the idle share 1 - busy / the median unprofiled wall (the profiler's
    own cost stretches the profiled call's wall, so its share is printed
    beside, not used); and the peak device memory over these calls, the
    path's inputs included."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            key = _kernel_name(e.name)
            by_name[key] = by_name.get(key, 0.0) + e.device_time / 1e3
    busy = sum(by_name.values())
    median = float(np.median(walls))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    top += [(k, by_name[k]) for k in WATCHED
            if k in by_name and k not in dict(top)]
    print(f"profile: {name}: walls {', '.join(f'{w:.3f}' for w in walls)} "
          f"ms (median {median:.3f}); busy {busy:.3f} ms, idle "
          f"{100 * (1 - busy / median):.1f} % of the median wall; profiled "
          f"call {wall:.3f} ms, idle {100 * (1 - busy / wall):.1f} % of it; "
          f"{'; '.join(f'{k} {v:.3f}' for k, v in top)}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
          f"[{card}]")


def _time_pair(name, what, kernel_fn, plain_fn, errs, times, card, inputs,
               library_fn=None, reps=10, keep=True, library_is_plain=False):
    """Hold a kernel equal to its plain version at a path's shape, then time
    it, the plain version and, where one torch call computes the same
    function, that call with CUDA events, in that order; the bound counts
    ``inputs`` and the kernel's outputs.  Where the plain version is itself
    that library call (``library_is_plain``), its time is reported for both.
    The first shape timed is the one reported (``keep=False`` prints a
    shape's times without reporting them)."""
    got, want = kernel_fn(), plain_fn()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(_err(g, w) for g, w in zip(got, want))
    errs[name] = max(errs[name], err)
    _require(not err, f"{name} differs from its plain version at {what}")
    bound = _bound_ms(inputs, got)
    del got, want
    ms = _events_ms(kernel_fn, reps)
    plain_ms = _events_ms(plain_fn, 3)
    library_ms = _events_ms(library_fn, reps) if library_fn else None
    if library_is_plain:
        library_ms = plain_ms
    if keep:
        times.setdefault(name, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                    library_ms=library_ms))
    lib = ("the plain version" if library_is_plain else
           f"{library_ms:.4f} ms" if library_fn else "none")
    print(f"kernel times: {name} at {what}: {ms:.4f} ms, plain {plain_ms:.4f}"
          f" ms, library {lib}, bound {bound:.4f} ms, max_abs_err={err} "
          f"[{card}]")


def _paths(dev, card, errs, times) -> dict:
    """Every plan beyond the headline join, once each, at 2^27 keys a side
    (the heavy hitter at 2^24), then its kernels' times at its shape."""
    n = 1 << LOG2_N
    tiles = n // TILE
    gauss = n * (n + 1) // 2
    total = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # build-only, locality: the reference's default run with the probe off
    r = local_shuffled_keys(n, WINDOW, 0, dev)
    res = {}
    add(_run_path(
        "build-only local_shuffled w16 (blocks)",
        lambda: res.setdefault("out", bb.banded_build_pipelined(
            r, tile=TILE, locality_window=WINDOW)),
        {"sort_tiles": 1}, card))
    out = res["out"]
    _require(out.violations == 0 and not out.resorted
             and out.output_sum == out.input_sum == gauss,
             f"build-only locality: {out}")
    _profile("build-only w16", lambda: bb.banded_build_pipelined(
        r, tile=TILE, locality_window=WINDOW), card)
    r_flat = bb.to_tiles(r, TILE)
    kw = dict(tile=TILE, method="blocks", passes=WINDOW)
    _time_pair("sort_tiles", f"2^{LOG2_N} blocks w16",
               lambda: st.sort_tiles(r_flat, **kw),
               lambda: st.sort_tiles_ref(r_flat, **kw), errs, times, card,
               (r_flat,), lambda: torch.sort(r_flat.view(-1, TILE), dim=1))
    del r, r_flat

    # build-only, no locality: per-tile bitonic
    r = shuffled_keys(n, 1, dev)
    res = {}
    add(_run_path("build-only shuffled (bitonic)",
                  lambda: res.setdefault("out", bb.banded_build_pipelined(
                      r, tile=TILE)),
                  {"sort_tiles": 1}, card))
    out = res["out"]
    _require(out.output_sum == out.input_sum == gauss,
             f"build-only shuffled: {out}")
    _profile("build-only shuffled", lambda: bb.banded_build_pipelined(
        r, tile=TILE), card)
    kw = dict(tile=TILE, method="bitonic")
    _time_pair("sort_tiles", f"2^{LOG2_N} bitonic",
               lambda: st.sort_tiles(r, **kw),
               lambda: st.sort_tiles_ref(r, **kw), errs, times, card,
               (r,), lambda: torch.sort(r.view(-1, TILE), dim=1))
    del r

    # wide band: window 4096 > 512 takes the bitonic tile sort and K4
    r = local_shuffled_keys(n, 4096, 2, dev)
    s = sorted_keys(n, dev)
    s2d = bb.prepare_probe_side(s, TILE)
    res = {}
    add(_run_path(
        "wide band local_shuffled w4096 x sorted (narrow=False)",
        lambda: res.setdefault("out", bb.banded_join_pipelined(
            r, s, tile=TILE, locality_window=4096, narrow=False, s2d=s2d)),
        {"sort_tiles": 1, "banded_count": 1}, card))
    out = res["out"]
    _require(out.matches == n and out.overflow_tiles == 0
             and out.output_sum == out.input_sum == gauss,
             f"wide band: {out}")
    _profile("wide band", lambda: bb.banded_join_pipelined(
        r, s, tile=TILE, locality_window=4096, narrow=False, s2d=s2d), card)
    sorted_flat, stats = st.sort_tiles(r, tile=TILE, method="bitonic")
    row_off, rows_needed = bb._rows(*bb._slice_offsets(
        s, stats[:, 0], stats[:, 1]))
    n_chunks = bb._n_chunks(rows_needed, TILE)
    _time_pair("banded_count", f"2^{LOG2_N} wide band w4096 (chunks "
               f"{int(n_chunks.min())}..{int(n_chunks.max())})",
               lambda: bc.banded_count(sorted_flat, s2d, row_off, n_chunks,
                                       tile=TILE),
               lambda: bc.banded_count_ref(sorted_flat, s2d, row_off,
                                           n_chunks, tile=TILE),
               errs, times, card, (sorted_flat, s2d, row_off, n_chunks))
    del r, sorted_flat, stats

    # sort-first: shuffled R sorted globally (K3), then K5
    r = shuffled_keys(n, 3, dev)
    res = {}
    add(_run_path(
        "sort-first shuffled x sorted (presort, unique_both)",
        lambda: res.setdefault("out", bb.banded_join_pipelined(
            r, s, tile=TILE, presort=True, unique_both=True, s2d=s2d)),
        {"global_sort_tiles": 1, "banded_count_narrow": 1}, card))
    out = res["out"]
    _require(out.matches == n and out.overflow_tiles == 0
             and out.output_sum == out.input_sum == gauss,
             f"sort-first: {out}")
    _profile("sort-first", lambda: bb.banded_join_pipelined(
        r, s, tile=TILE, presort=True, unique_both=True, s2d=s2d), card)
    padded = bb.to_tiles_pow2(r, TILE)
    _time_pair("global_sort_tiles", f"2^{LOG2_N} shuffled",
               lambda: gs.global_sort_tiles(padded, tile=TILE),
               lambda: gs.global_sort_ref(padded), errs, times, card,
               (padded,), reps=5, library_is_plain=True)
    r_sorted = gs.global_sort_tiles(padded, tile=TILE)
    mins, maxs, _ = st.tile_stats(r_sorted, TILE)
    row_off, rows_needed = bb._rows(*bb._slice_offsets(s, mins, maxs))
    _time_pair("banded_count_narrow", f"2^{LOG2_N} sort-first",
               lambda: bcn.banded_count_narrow(r_sorted, s2d, row_off,
                                               rows_needed, tile=TILE),
               lambda: bcn.banded_count_narrow_ref(r_sorted, s2d, row_off,
                                                   rows_needed, tile=TILE),
               errs, times, card, (r_sorted, s2d, row_off, rows_needed))
    del padded, r_sorted

    # the switch: locality declared but absent -> K1, K1 retry, sort-first
    res = {}
    add(_run_path(
        "switch shuffled x sorted declared w16",
        lambda: res.setdefault("out", bb.banded_join_pipelined(
            r, s, tile=TILE, locality_window=WINDOW, s2d=s2d)),
        {"fused_sort_count": 2, "global_sort_tiles": 1,
         "banded_count_narrow": 1}, card))
    out = res["out"]
    _require(out.resorted and out.violations > 0
             and out.overflow_tiles > tiles // 8 and out.matches == n
             and out.output_sum == out.input_sum == gauss, f"switch: {out}")
    _profile("switch", lambda: bb.banded_join_pipelined(
        r, s, tile=TILE, locality_window=WINDOW, s2d=s2d), card)
    del r, s, s2d

    # skewed probe: shuffled pk R x unsorted zipf S (mc -z), repair included
    r = shuffled_keys(n, 5, dev)
    s = zipf_keys(n, n, 1.0, 6, dev)
    res = {}
    add(_run_path(
        "skewed probe pk x zipf(theta 1.0) unsorted (sort_s, presort)",
        lambda: res.setdefault("out", bb.banded_join_pipelined(
            r, s, tile=TILE, sort_s=True, presort=True)),
        {"global_sort_tiles": 2, "banded_count": 2}, card))
    out = res["out"]
    _require(out.overflow_tiles > 0 and out.matches == n
             and out.output_sum == out.input_sum == gauss,
             f"skewed probe: {out}")
    _profile("skewed probe", lambda: bb.banded_join_pipelined(
        r, s, tile=TILE, sort_s=True, presort=True), card)
    args = _repair_inputs(r, s)
    del r, s
    bad_tiles = args[0].numel() // TILE
    _time_pair("banded_count", f"the skewed probe's repair ({bad_tiles} "
               f"tiles, chunks {args[3].tolist()})",
               lambda: bc.banded_count(*args, tile=TILE),
               lambda: bc.banded_count_ref(*args, tile=TILE), errs, times,
               card, args, keep=False)
    del args

    # heavy hitter: 2^24 copies of one key a side, 2^48 pairs
    m = 1 << (LOG2_N - 3)
    hot = torch.full((m,), 12345, dtype=torch.int32, device=dev)
    res = {}
    add(_run_path(
        "heavy hitter 2^24 x 2^24 copies (presorted, in-place recount)",
        lambda: res.setdefault("out", bb.banded_join_pipelined(
            hot, hot, tile=TILE, presorted=True)),
        {"banded_count": 2}, card))
    out = res["out"]
    _require(out.matches == m * m and out.resorted,
             f"heavy hitter: {out}")
    _profile("heavy hitter", lambda: bb.banded_join_pipelined(
        hot, hot, tile=TILE, presorted=True), card)
    del hot
    torch.cuda.empty_cache()
    return total


def _scatter_inputs(keys, tile, fanout, shift, parent=None, n_parents=1,
                    align=False):
    """One radix pass's K6 inputs: the keys tile-sorted by K2, and the
    pass's plan (tile-digit bounds, then destination rows)."""
    sorted_flat, _ = st.sort_tiles(rk._to_tiles(keys, tile), tile=tile,
                                   method="bitonic")
    bounds = rk.tile_digit_bounds(sorted_flat, fanout=fanout, shift=shift,
                                  tile=tile)
    if parent is None:
        parent = torch.zeros(bounds.shape[0], dtype=torch.int32,
                             device=keys.device)
    plan = rk.scatter_plan(bounds, parent, fanout=fanout,
                           rows_per_tile=tile // 128, align_tiles=align,
                           n_parents=n_parents)
    return sorted_flat, plan


def _check_scatter(dev, errs) -> None:
    """K6 against its plain version on cases of a few tiles, exactly: fanout
    128 at tile 8192, an alphabet of three keys (empty runs, runs of many
    rows), tile-aligned duplicate regions, and a three-pass partition held
    pass for pass to the same partition on the CPU."""
    n = 5 * TILE - 300
    cases = [("permutation, fanout 128", pk_keys(n, 1, dev), 128, 8, False),
             ("alphabet 1..3, fanout 4", _duplicates(n, dev, 8) % 3 + 1, 4,
              0, False),
             ("duplicates, fanout 128, aligned", _duplicates(n, dev, 9), 128,
              4, True)]
    for case, keys, fanout, shift, align in cases:
        sorted_flat, plan = _scatter_inputs(keys, TILE, fanout, shift,
                                            align=align)
        args = (sorted_flat, plan.a_elem, plan.dest_row)
        kw = dict(tile=TILE, out_rows=plan.out_rows)
        got = sct.scatter_tiles(*args, **kw)
        err = _err(got, sct.scatter_tiles_ref(*args, **kw))
        vals = got[got != MAXI32]
        _require(torch.equal(torch.sort(vals).values,
                             torch.sort(keys).values),
                 f"K6 lost keys on {case}")
        runs = (plan.hist > 0).sum(1)
        print(f"kernel: K6 on {case}: {plan.a_elem.shape[0]} tiles, "
              f"{plan.out_rows} rows out, runs per tile {int(runs.min())}.."
              f"{int(runs.max())}, longest run {int(plan.hist.max())} keys, "
              f"max_abs_err={err}")
        _require(not err, f"K6 differs from its plain version on {case}")
        errs["scatter_tiles"] = max(errs["scatter_tiles"], err)
    keys = shuffled_keys(6 * TILE + 77, 2, dev)
    kw = dict(radix_bits=12, passes=3, key_bits=keys.numel().bit_length(),
              tile=TILE)
    before = sct.LAUNCHES
    got = rk.multipass_radix_partition(keys, **kw)
    launches = sct.LAUNCHES - before
    want = rk.multipass_radix_partition(keys.cpu(), **kw)
    err = max([_err(got.partitioned.cpu(), want.partitioned)] +
              [_err(g.cpu(), w) for g, w in zip(got.pass_hists,
                                                 want.pass_hists)])
    print(f"kernel: K6 in a three-pass partition ({[p.bits for p in got.pass_plans]}"
          f" bits): {launches} launches, max_abs_err={err} (against the "
          f"same partition on the CPU)")
    _require(not err and launches == 3, "the three-pass partition differs")
    errs["scatter_tiles"] = max(errs["scatter_tiles"], err)


def _radix(dev, card, errs, times) -> dict:
    """K6 on few tiles, the multipass radix join at 2^27 (and build-only),
    then K6 against its plain version at the join's two pass shapes."""
    _check_scatter(dev, errs)
    n = 1 << LOG2_N
    gauss = n * (n + 1) // 2
    total = dict.fromkeys(KERNELS, 0)
    cfg = JoinConfig(algo=Algo.RADIX, r_size=n, data_distr=Distribution.PK,
                     radix_bits=14, radix_passes=2,
                     radix_strategy="multipass", seed=11)
    r, s = build_relations(cfg, dev)
    res = {}
    counts = _run_path(
        "multipass radix pk x sorted, 14 bits in 2 passes (radix_join)",
        lambda: res.setdefault("m", radix_join(r, s, cfg)).to_json_line(),
        {"scatter_tiles": 2, "sort_tiles": 3, "banded_count": 1}, card)
    peak = torch.cuda.max_memory_allocated()
    m = res["m"]
    print(f"path: multipass radix peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB, relations included) [{card}]")
    _require(m.totalMatches == n and m.inputSum == m.outputSum == gauss
             and m.extra["passBits"] == [7, 7]
             and m.extra["backend"] == "pallas_multipass_radix"
             and counts["scatter_tiles"] == 2, f"multipass radix: {m}")
    for k, v in counts.items():
        total[k] += v
    _profile("multipass radix join", lambda: radix_join(r, s, cfg), card)
    res = {}
    counts = _run_path(
        "multipass radix build-only (radix_join, no probe side)",
        lambda: res.setdefault("m", radix_join(r, None, cfg)).to_json_line(),
        {"scatter_tiles": 2, "sort_tiles": 3}, card)
    _require(res["m"].inputSum == res["m"].outputSum == gauss
             and res["m"].totalMatches is None, f"build-only: {res['m']}")
    _profile("multipass radix build-only", lambda: radix_join(r, None, cfg),
             card)
    for k, v in counts.items():
        total[k] += v
    del s

    # K6 at the pass shapes of that join: pass 1 over the 2^27 keys,
    # pass 2 over pass 1's tile-aligned output with 128 parents
    passes = rk.plan_passes(n.bit_length(), 14, 2)   # _max_key_bound: n
    sorted_flat, plan = _scatter_inputs(r.keys, TILE, 128, passes[0].shift,
                                        align=True)
    del r
    args = (sorted_flat, plan.a_elem, plan.dest_row)
    kw = dict(tile=TILE, out_rows=plan.out_rows)
    _time_pair("scatter_tiles", f"2^{LOG2_N} pass 1 ({plan.a_elem.shape[0]} "
               f"tiles -> {plan.out_rows} rows)",
               lambda: sct.scatter_tiles(*args, **kw),
               lambda: sct.scatter_tiles_ref(*args, **kw), errs, times, card,
               args)
    out1 = sct.scatter_tiles(*args, **kw)
    parent = rk._parents_from_regions(plan.region_rows,
                                      n_tiles=out1.numel() // TILE,
                                      rows_per_tile=TILE // 128)
    del args, sorted_flat, plan
    sorted_flat, plan = _scatter_inputs(out1, TILE, 128, passes[1].shift,
                                        parent=parent, n_parents=128)
    del out1
    args = (sorted_flat, plan.a_elem, plan.dest_row)
    kw = dict(tile=TILE, out_rows=plan.out_rows)
    _time_pair("scatter_tiles", f"2^{LOG2_N} pass 2 ({plan.a_elem.shape[0]} "
               f"tiles -> {plan.out_rows} rows)",
               lambda: sct.scatter_tiles(*args, **kw),
               lambda: sct.scatter_tiles_ref(*args, **kw), errs, times, card,
               args, reps=5, keep=False)
    # K2 at the join's final sort: the pass-2 output, mostly MAXI32 padding
    out = sct.scatter_tiles(*args, **kw)
    del args, sorted_flat, plan
    n_out = out.numel() // TILE
    n_pad = int((out.view(-1, TILE) == MAXI32).all(1).sum())
    _time_pair("sort_tiles", f"the multipass final sort ({n_out} tiles, "
               f"{n_pad} of MAXI32 only, {int((out != MAXI32).sum())} keys)",
               lambda: st.sort_tiles(out, tile=TILE, method="bitonic"),
               lambda: st.sort_tiles_ref(out, tile=TILE, method="bitonic"),
               errs, times, card, (out,), reps=5, keep=False)
    del out
    torch.cuda.empty_cache()
    return total


def _cli_lines(argv, dev) -> list:
    """Run the CLI in-process on ``dev``; return its JSON lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _require(cli.main(argv, device=dev) == 0, f"cli {argv} failed")
    print(f"cli: {' '.join(argv)}")
    return [json.loads(line) for line in buf.getvalue().strip().splitlines()]


def _cli_line(argv, dev) -> dict:
    """Run the CLI in-process on ``dev``; return its (last) JSON line."""
    return _cli_lines(argv, dev)[-1]


def _cli_paths(dev, card) -> dict:
    """The CLI at --rSize 2^27, one run per path the planner chooses, each
    line checked: counts, conservation, the path taken, its kernels."""
    n = 1 << LOG2_N
    total = dict.fromkeys(KERNELS, 0)
    runs = [
        (["--algo", "adaptive", "--dataDistr", "local_shuffle"],
         {"fused_sort_count": 1}, "htm"),
        (["--algo", "adaptive", "--dataDistr", "uniform", "--distinctKeys",
          str(n // 2)], {"global_sort_tiles": 1}, "radix"),
        (["--algo", "adaptive", "--dataDistr", "random"],
         {"global_sort_tiles": 1}, "radix"),
        (["--algo", "PRO", "-r", str(n), "-s", str(n)],
         {"global_sort_tiles": 2}, None),
        (["--algo", "htm", "--switchSniff", "--dataDistr", "zipf"],
         {"global_sort_tiles": 2}, None),
    ]
    for argv, expect, path in runs:
        if "-r" not in argv:
            argv = argv + ["--rSize", str(n)]
        res = {}
        counts = _run_path(f"cli {' '.join(argv)}",
                           lambda: res.setdefault("d", _cli_line(argv, dev)),
                           expect, card)
        d = res["d"]
        for k, v in counts.items():
            total[k] += v
        ok = d["inputSum"] == d["outputSum"] and d.get("chosenPath") == path
        if "random" in argv:
            # the sort route: S is a copy of R; an independent count of
            # sum over keys of multiplicity^2
            cfg, _ = cli.parse_args(argv)
            r, _ = build_relations(cfg, dev)
            _, mult = torch.unique(r.keys, return_counts=True)
            want = int((mult.long() ** 2).sum())
            del r, mult
            ok = ok and "backend" not in d and d["totalMatches"] == want
        elif "uniform" in argv:
            ok = ok and d["backend"] == "pallas_banded" \
                and d["totalMatches"] == n
        elif "--switchSniff" in argv:
            ok = ok and d["switchedToRadix"] is True and d["totalMatches"] == n
        else:
            ok = ok and d["totalMatches"] == n
        _require(ok, f"cli {argv}: {d}")
        if "global_sort_tiles" in expect:
            # the join alone, relations already on the card, as cli.main
            # times it
            cfg, _ = cli.parse_args(argv)
            r, s = build_relations(cfg, dev)
            _profile(f"cli {' '.join(argv[:4])}",
                     lambda: DISPATCH[cfg.algo.value](r, s, cfg), card)
            del r, s
        torch.cuda.empty_cache()
    return total


def _untimed(line: dict) -> dict:
    """A JSON line without its times (singleRunTimeInMicroseconds too)."""
    return {k: v for k, v in line.items() if "Time" not in k}


def _hash_lines_equal_the_cpu(dev) -> None:
    """The scatter builds at 2^22 through DISPATCH, on the card and on the
    CPU (the same keys, copied): the lines agree on every field but the
    times, so the highest-row winner holds on the card."""
    n = 1 << HASH_LOG2_N
    uniform = dict(data_distr=Distribution.UNIFORM, distinct_keys=n >> 2)
    cases = [(algo, dict(backend="xla", enable_probe=probing, **dist))
             for algo in ("nocc", "atomic", "htm")
             for dist in (dict(data_distr=Distribution.SORTED),
                          dict(data_distr=Distribution.SHUFFLE), uniform)
             for probing in (False, True)]
    cases += [("npo_st", dict(data_distr=Distribution.PK,
                              s_distr=Distribution.FK)),
              ("nocc", dict(data_distr=Distribution.RANDOM))]
    for algo, fields in cases:
        cfg = JoinConfig(algo=Algo(algo), r_size=n, seed=13, **fields)
        r, s = build_relations(cfg, dev)
        probing = cfg.enable_probe
        t0 = time.perf_counter()
        got = DISPATCH[algo](r, s if probing else None, cfg).to_dict()
        card_s = time.perf_counter() - t0
        cpu_s = Relation(s.keys.cpu(), assume_sorted=s.assume_sorted)
        want = DISPATCH[algo](Relation(r.keys.cpu()),
                              cpu_s if probing else None, cfg).to_dict()
        same = _untimed(got) == _untimed(want)
        print(f"hash: 2^{HASH_LOG2_N} {algo} {fields}: card line equals the "
              f"CPU's: {same}; matches {got.get('totalMatches')}, conflicts "
              f"{got.get('conflicts', got.get('conflictCount'))}, "
              f"outputSum {got['outputSum']} of {got['inputSum']}; card "
              f"call {card_s:.4f} s")
        _require(same and "backend" not in got,
                 f"2^{HASH_LOG2_N} {algo} {fields}: card {got} != CPU "
                 f"{want}")
        del r, s, cpu_s
    torch.cuda.empty_cache()


def _check_claim_insert(dev, card, errs, times) -> None:
    """The claim-round kernel against its plain version (the torch claim
    rounds, ``insert.open_addressing_build_ref``, on the card): duplicates
    with key 0 (EMPTY) among them, row 0's key included, at budgets 1, 4
    and 6, exactly; then the hash cell's build, 2^27 shuffled keys into
    2^28 slots under the identity hash, held equal and timed at budget 4
    (the packed word; reported) and 6 (two launches a round; printed, not
    reported), and the budget-4 build split by launch under the
    profiler."""
    m = 1 << 20
    keys = _duplicates(m, dev, 41)
    keys[::97] = 0
    for budget in (1, 4, 6):
        args = (keys, m, budget, identity_hash)
        got = insert.open_addressing_build(*args)
        want = insert.open_addressing_build_ref(*args)
        err = max(_err(g, w) for g, w in zip(got, want))
        errs["claim_insert"] = max(errs["claim_insert"], err)
        print(f"kernel: claim_insert 2^20 duplicates with key 0, budget "
              f"{budget}: spilled {int(want[1].sum())}, max_abs_err={err}")
        _require(not err, f"the claim kernel differs from its plain version "
                 f"on key 0 at budget {budget}")
    del keys, got, want
    n = 1 << LOG2_N
    keys = shuffled_keys(n, 1, dev)
    before = insert.LAUNCHES
    for budget, keep in ((4, True), (6, False)):
        args = (keys, 2 * n, budget, identity_hash)
        _time_pair("claim_insert", f"2^{LOG2_N} shuffled keys into "
                   f"2^{LOG2_N + 1} slots, budget {budget}",
                   lambda: insert.open_addressing_build(*args),
                   lambda: insert.open_addressing_build_ref(*args), errs,
                   times, card, (keys,), keep=keep)
    times["claim_insert"]["kernel_phase_launches"] = insert.LAUNCHES - before
    args = (keys, 2 * n, 4, identity_hash)
    ops = _device_ops(lambda: insert.open_addressing_build(*args))
    print(f"kernel: claim_insert build at 2^{LOG2_N} budget 4, one profiled "
          f"call: {sum(t for _, t in ops):.4f} ms busy in {len(ops)} ops: "
          f"{', '.join(f'{name} {t:.4f}' for name, t in ops)} [{card}]")
    print(f"kernel: claim_insert builds in its kernel phase "
          f"{insert.LAUNCHES - before} [{card}]")
    del keys
    torch.cuda.empty_cache()


def _check_hash_probe(dev, card, errs, times) -> None:
    """The table-probe kernel against its plain version (the torch
    gathers, ``probe_open_addressing_ref`` and ``probe_buckets_ref``, on
    the card): the hash cell's probe, 2^27 sorted S keys into the 2^28-slot
    table that the claim kernel builds from 2^27 shuffled keys, budget 4,
    held equal and timed (reported; the bound reads each S key and its
    home slots once, 8 bytes a key); a shuffled S into that table; npo's
    2-slot and htm's 3-slot bucket tables of the same keys under sorted S;
    each held equal and timed (printed, not reported), and the cell's
    probe split under the profiler."""
    n = 1 << LOG2_N
    rkeys = shuffled_keys(n, 1, dev)
    skeys = sorted_keys(n, dev)
    table, pending = insert.open_addressing_build(rkeys, 2 * n, 4,
                                                  identity_hash)
    _require(int(pending.sum()) == 0, "the cell's build spilled")
    before = probe.LAUNCHES
    args = (table, skeys, 4, identity_hash)
    _time_pair("hash_probe", f"2^{LOG2_N} sorted S into 2^{LOG2_N + 1} "
               f"slots, budget 4",
               lambda: probe.probe_open_addressing(*args),
               lambda: probe.probe_open_addressing_ref(*args), errs, times,
               card, (skeys, table[:n]))
    _require(int(probe.probe_open_addressing(*args)) == n,
             "the cell's probe did not find every S key")
    ops = _device_ops(lambda: probe.probe_open_addressing(*args))
    print(f"kernel: hash_probe at 2^{LOG2_N} budget 4, one profiled call: "
          f"{sum(t for _, t in ops):.4f} ms busy in {len(ops)} ops: "
          f"{', '.join(f'{name} {t:.4f}' for name, t in ops)} [{card}]")
    shuffled = shuffled_keys(n, 2, dev)
    args = (table, shuffled, 4, identity_hash)
    _time_pair("hash_probe", f"2^{LOG2_N} shuffled S into 2^{LOG2_N + 1} "
               f"slots, budget 4",
               lambda: probe.probe_open_addressing(*args),
               lambda: probe.probe_open_addressing_ref(*args), errs, times,
               card, (shuffled, table[:n]), keep=False)
    del table, pending, shuffled, args
    torch.cuda.empty_cache()
    npo_table, _ = insert.bucket_build(rkeys, n // 2, 2, identity_hash)
    htm_table = insert.htm_optimistic_build(
        rkeys, htm_num_buckets(n)).table
    for what, table, slots, hash_fn in (
            ("npo's 2-slot buckets", npo_table, 2, identity_hash),
            ("htm's 3-slot buckets", htm_table, 3, locality_hash)):
        args = (table, skeys, slots, hash_fn)
        _time_pair("hash_probe", f"2^{LOG2_N} sorted S into {what}",
                   lambda: probe.probe_buckets(*args),
                   lambda: probe.probe_buckets_ref(*args), errs, times,
                   card, (skeys, table[:n]), keep=False)
    times["hash_probe"]["kernel_phase_launches"] = probe.LAUNCHES - before
    print(f"kernel: hash_probe launches in its kernel phase "
          f"{probe.LAUNCHES - before} [{card}]")
    del rkeys, skeys, npo_table, htm_table, args
    torch.cuda.empty_cache()


def _hash_joins(dev, card, errs, times) -> dict:
    """The claim and probe kernels against their plain versions; the
    hash-table joins and sortmerge: the card against the CPU at 2^22, then
    the reference's own points at 2^27 through cli.main, each line checked
    (exact matches, conservation or nocc's inequalities, conflicts on
    unique keys, every kernel's launches), with a profile of each
    scatter-build path."""
    _check_claim_insert(dev, card, errs, times)
    _check_hash_probe(dev, card, errs, times)
    _hash_lines_equal_the_cpu(dev)
    n = 1 << LOG2_N
    total = dict.fromkeys(KERNELS, 0)
    build_only = ["--noProbe", "--noRetry", "--probeLength", "4",
                  "--backend", "xla"]
    runs = []     # (argv, launches, a scatter build or the plain route)
    # the claim kernel builds atomic's table, npo's buckets and htm's retry
    # rounds (none with --noRetry); nocc's rounds are torch ops; the probe
    # kernel probes every scatter table
    claims = {"nocc": {}, "atomic": {"claim_insert": 1},
              "htm": {"claim_insert": 1}}
    probes = {algo: {**c, "hash_probe": 1} for algo, c in claims.items()}
    for algo in ("nocc", "atomic", "htm"):       # AtomicsVsHTMVsNoCC
        for dist in ("sorted", "shuffle"):
            runs.append((["--algo", algo, "--dataDistr", dist,
                          "--transactionSize",
                          "1" if algo == "htm" else "16", *build_only],
                         {} if algo == "htm" else claims[algo], True))
    for algo in ("nocc", "atomic", "htm"):       # probe.sh's first point
        runs.append((["--algo", algo, "--backend", "xla", "--dataDistr",
                      "local_shuffle", "--shuffleRange", "16"],
                     probes[algo], True))
    for algo in ("nocc", "atomic"):              # duplicates, 2^24 distinct
        runs.append((["--algo", algo, "--dataDistr", "uniform",
                      "--distinctKeys", str(n >> 3)], probes[algo], True))
    runs += [
        (["--algo", "htm", "--dataDistr", "uniform", "--distinctKeys",
          str(n >> 3)], {"global_sort_tiles": 1, "banded_count": 1}, False),
        (["--algo", "NPO", "-r", str(n), "-s", str(n)],
         {"global_sort_tiles": 2, "banded_count_narrow": 1}, False),
        (["--algo", "NPO_st", "-r", str(n), "-s", str(n)],
         {"claim_insert": 1, "hash_probe": 1}, True),
        (["--algo", "sortmerge", "--dataDistr", "shuffle"],
         {"global_sort_tiles": 1, "banded_count_narrow": 1}, False),
        (["--algo", "sortmerge", "--dataDistr", "random"],
         {"global_sort_tiles": 2}, True),
        (["--algo", "atomic", "--dataDistr", "shuffle"],
         {"global_sort_tiles": 1, "banded_count_narrow": 1}, False),
    ]
    for argv, launches, scatter in runs:
        if "-r" not in argv:
            argv = argv + ["--rSize", str(n)]
        res = {}
        counts = _run_path(f"cli {' '.join(argv)}",
                           lambda: res.setdefault("d", _cli_line(argv, dev)),
                           launches, card)
        d = res["d"]
        for k, v in counts.items():
            total[k] += v
        cfg, _ = cli.parse_args(argv)
        algo = cfg.algo.value
        if cfg.s_distr == Distribution.FK:
            exact = cfg.s_size                       # PK x FK
        elif cfg.data_distr == Distribution.RANDOM:
            r, _ = build_relations(cfg, dev)         # S is a copy of R
            _, mult = torch.unique(r.keys, return_counts=True)
            exact = int((mult.long() ** 2).sum())
            del r, mult
        else:
            exact = n                  # each R key meets one key of 1..n
        conflicts = d.get("conflicts", d.get("conflictCount"))
        unique = cfg.data_distr.value in ("sorted", "shuffle",
                                          "local_shuffle", "pk")
        if algo == "nocc":
            ok = d["outputSum"] <= d["inputSum"] and (
                not cfg.enable_probe or d["totalMatches"] <= exact)
            if unique:    # no key collides under key & (2n - 1)
                ok = ok and d["outputSum"] == d["inputSum"]
        else:
            ok = d["outputSum"] == d["inputSum"] and (
                not cfg.enable_probe or d["totalMatches"] == exact)
        ok = ok and (conflicts == 0 or not unique) and (
            ("backend" not in d) == scatter)
        ok = ok and all(counts[k] == launches.get(k, 0) for k in counts)
        print(f"hash: {' '.join(argv)}: matches {d.get('totalMatches')} "
              f"(exact {exact if cfg.enable_probe else '-'}), conflicts "
              f"{conflicts}, outputSum {d['outputSum']} of {d['inputSum']}, "
              f"build {d['hashBuildTimeInMicroseconds']:.1f} us, probe "
              f"{d.get('probeTimeInMicroseconds')} us [{card}]")
        _require(ok, f"cli {argv}: {d}; launches {counts}")
        if scatter:
            # the join alone, relations already on the card
            r, s = build_relations(cfg, dev)
            _profile(f"cli {' '.join(argv)}",
                     lambda: DISPATCH[algo](r, s, cfg), card)
            del r, s
        torch.cuda.empty_cache()
    return total


def _pairs(a, b):
    """(a, b) int32 pairs as sorted int64 composites: a multiset."""
    return torch.sort((a.long() << 32) | (b.long() & 0xFFFFFFFF)).values


K7A_KINDS = ("all equal", "sorted", "reversed", "16 copies a key",
             "MAXI32 padding in the last block", "INT32_MIN and negatives")


def _k7a_case(kind, tile, n_tiles, gen, dev):
    """(keys, values) of n_tiles tiles (the kinds of
    tests/test_torch_cuda.py); the values are distinct, so a tie out of
    input order shows."""
    n = tile * n_tiles
    wide = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    if kind == "all equal":
        keys = torch.full((n,), -7, dtype=torch.int32, device=dev)
    elif kind == "sorted":
        keys = torch.sort(wide >> 20).values
    elif kind == "reversed":
        keys = torch.sort(wide >> 20, descending=True).values
    elif kind in ("16 copies a key", "MAXI32 padding in the last block"):
        keys = torch.randint(0, max(1, n // 16), (n,), generator=gen,
                             device=dev, dtype=torch.int32)
        if kind != "16 copies a key":
            keys[n - tile // 2 - 5:] = MAXI32
    else:
        keys = wide.clone()
        keys[::97] = -2**31
        keys[1::89] = MAXI32
        keys[2::13] = -1
    vals = (torch.randperm(n, generator=gen, device=dev) - n // 2).int()
    return keys, vals


def _check_k7a(dev, errs) -> None:
    """K7a alone against its plain version (stable sort + gather), bit for
    bit: both sort stably, the kernel by (key, row) composites; at every
    kernel tile, in both directions, on each of K7A_KINDS in one tile and
    in 64."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    for tile in skv.KERNEL_TILES:
        for kind in K7A_KINDS:
            for n_tiles in (1, 64):
                k, v = _k7a_case(kind, tile, n_tiles, gen, dev)
                for alternate in (False, True):
                    got = skv.sort_kv_tiles(k, v, tile=tile,
                                            alternate=alternate)
                    torch.cuda.synchronize()
                    want = skv.sort_kv_tiles_ref(k, v, tile=tile,
                                                 alternate=alternate)
                    err = max(_err(got[0], want[0]), _err(got[1], want[1]))
                    errs["sort_kv_tiles"] = max(errs["sort_kv_tiles"], err)
                    _require(not err, f"K7a differs from its plain version "
                             f"on {kind}, {n_tiles} tiles of {tile}, "
                             f"alternate={alternate}")
    print(f"kernel: K7a alone at tiles {skv.KERNEL_TILES}, both directions, "
          f"on {', '.join(K7A_KINDS)}, 1 and 64 tiles: equal to its plain "
          f"version bit for bit")


def _check_kv(dev, errs) -> None:
    """K7 against its plain version (stable sort + gather) on cases of a few
    tiles of the split's tile, exactly; then K7a alone (_check_k7a)."""
    tile = wpart.KV_TILE
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)

    def vals(n):
        return torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             device=dev, dtype=torch.int32)

    n = 100 * tile
    keys = torch.randint(1, 1 << 24, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    shard = (torch.arange(n, device=dev, dtype=torch.int32) // 4096) % 8
    rot = wpart._rot_pack(keys, shard, 1, 17, 6, 19, 3, 128 * tile)
    dup = torch.repeat_interleave(torch.arange(1, 2 * tile + 1,
                                               dtype=torch.int32,
                                               device=dev), 16)
    wide = _full_range(4 * tile, dev, 18)
    cases = [("one tile", torch.randperm(tile, generator=gen, device=dev)),
             ("two tiles", torch.randperm(2 * tile, generator=gen,
                                          device=dev)),
             ("2^3 tiles, MAXI32 padding",
              torch.cat([torch.randperm(8 * tile - 999, generator=gen,
                                        device=dev),
                         torch.full((999,), MAXI32, device=dev)])),
             ("2^5 tiles, 16 copies a key",
              dup[torch.randperm(dup.numel(), generator=gen, device=dev)]),
             ("2^7 tiles, rotation-packed keys with 3 shard bits", rot),
             ("2^2 tiles, negatives and INT32_MIN", wide),
             ("2^2 tiles, two values", torch.where(wide < 0, 3, -5))]
    for case, k in cases:
        k = k.to(torch.int32)
        v = vals(k.numel())
        before = (skv.LAUNCHES, gkv.LAUNCHES)
        got = gkv.global_sort_kv_tiles(k, v, tile=tile)
        torch.cuda.synchronize()
        launched = (skv.LAUNCHES - before[0], gkv.LAUNCHES - before[1])
        want = gkv.global_sort_kv_ref(k, v)
        err = max(_err(got[0], want[0]), _err(got[1], want[1]))
        errs["global_sort_kv_tiles"] = max(errs["global_sort_kv_tiles"], err)
        print(f"kernel: K7 on {case} ({k.numel()} pairs): {launched[1]} "
              f"launch, max_abs_err={err}")
        _require(not err and launched == (0, 1),
                 f"K7 differs from its plain version on {case}")
    _check_k7a(dev, errs)


def _expected_pairs(conf, dev, cache) -> torch.Tensor:
    """The multijoin's answer from a plain torch join of the conf's own two
    tables (generated anew from the same seeds): the PK build maps each key
    to one rid, so a probe row's partner is rid_of_key[probe key]."""
    key = json.dumps([conf["build"], conf["probe"]], sort_keys=True)
    if key not in cache:
        cache.clear()
        tb = load_side(conf["build"], ".", 1 << 20, dev)
        tp = load_side(conf["probe"], ".", 1 << 20, dev)
        bkeys, brid = tb.column(1), tb.column(2)
        _require(int(bkeys.min()) >= 1 and torch.equal(
            torch.sort(bkeys).values, torch.arange(
                1, bkeys.numel() + 1, dtype=bkeys.dtype, device=dev)),
            "the build side is not a primary key 1..N")
        rid_of_key = torch.zeros(bkeys.numel() + 1, dtype=brid.dtype,
                                 device=dev)
        rid_of_key[bkeys.long()] = brid
        cache[key] = _pairs(rid_of_key[tp.column(1).long()], tp.column(2))
        del tb, tp, rid_of_key
    return cache[key]


def _kv_split_shape(dev):
    """The independent conf's probe split at full scale, as K7 receives it:
    2^28 rotation-packed keys with 3 shard bits (64 buckets, skip 17) and
    the rid payload."""
    conf = parse_conf(WISCONSIN_CONFS + "independent.conf")
    side = conf["probe"]
    page = conf["partitioner"]["probe"]["pagesize"]
    tp = load_side(side, ".", page, dev)
    n = tp.num_rows
    shard = (torch.arange(n, dtype=torch.int32, device=dev) // page) % 8
    t = wpart._rot_pack(tp.column(1), shard, 1, 17, 6, 19, 3, n)
    return t, tp.column(2)


def _wisconsin(dev, card, errs, times) -> dict:
    """K7 on few tiles, the six shipped confs at the reference scale
    through run_multijoin, then K7a and K7 at the probe split's shape."""
    _check_kv(dev, errs)
    total = dict.fromkeys(KERNELS, 0)
    cache = {}
    for name, kv in CONFS.items():
        conf = parse_conf(f"{WISCONSIN_CONFS}{name}.conf")
        run_multijoin(conf, device=dev)            # first run, not reported
        torch.cuda.empty_cache()
        res = {}
        counts = _run_path(
            f"wisconsin {name}",
            lambda: res.setdefault("r", run_multijoin(conf, device=dev)
                                   ).to_json_line(),
            {"global_sort_kv_tiles": int(kv)}, card)
        peak = torch.cuda.max_memory_allocated()
        r = res.pop("r")
        k7 = counts["global_sort_kv_tiles"]
        rows_ok = r.output_rows == conf["probe"]["relation-size"]
        got = _pairs(r.output.column(1), r.output.column(2))
        del r
        match = torch.equal(got, _expected_pairs(conf, dev, cache))
        del got
        print(f"path: wisconsin {name}: K7 {k7} launches; peak device "
              f"memory {peak} bytes ({peak / 2**30:.3f} GiB); output equal "
              f"to the plain join as a multiset: {match} [{card}]")
        _require(rows_ok and match and counts["sort_kv_tiles"] == 0
                 and (k7 > 0 if kv else k7 == 0),
                 f"wisconsin {name}: output or K7 launches wrong")
        for k, v in counts.items():
            total[k] += v
        if kv:
            _profile(f"wisconsin {name} (generation included)",
                     lambda: run_multijoin(conf, device=dev), card)
        torch.cuda.empty_cache()
    del cache
    _require(total["global_sort_kv_tiles"] > 0, "no conf launched K7")

    # K7 at the probe split's shape, exactly; then K7a, the TPU's phase A,
    # which no path runs any more: its launches here are reported apart
    t, pay = _kv_split_shape(dev)
    what = f"2^{t.numel().bit_length() - 1} independent probe split"
    _time_pair("global_sort_kv_tiles", what,
               lambda: gkv.global_sort_kv_tiles(t, pay, tile=wpart.KV_TILE),
               lambda: gkv.global_sort_kv_ref(t, pay), errs, times, card,
               (t, pay), reps=3, library_is_plain=True)
    block = skv.MAX_TILE
    before = skv.LAUNCHES
    got = skv.sort_kv_tiles(t, pay, tile=block, alternate=True)
    want = skv.sort_kv_tiles_ref(t, pay, tile=block, alternate=True)
    err = max(_err(got[0], want[0]), _err(got[1], want[1]))
    errs["sort_kv_tiles"] = max(errs["sort_kv_tiles"], err)
    _require(not err, f"sort_kv_tiles differs from its plain version at {what}")
    bound = _bound_ms((t, pay), got)
    del got

    def library():
        """K7a's function in torch.sort: even blocks ascending, odd blocks
        descending, both stable, then a gather of the values (the plain
        version sorts every block first and the odd ones again)."""
        k = t.view(-1, block)
        keys = torch.empty_like(k)
        idx = torch.empty(k.shape, dtype=torch.int64, device=k.device)
        keys[0::2], idx[0::2] = torch.sort(k[0::2], dim=1, stable=True)
        keys[1::2], idx[1::2] = torch.sort(k[1::2], dim=1, descending=True,
                                           stable=True)
        return keys.view(-1), torch.gather(pay.view(-1, block), 1,
                                           idx).view(-1)

    lib = library()
    _require(torch.equal(lib[0], want[0]) and torch.equal(lib[1], want[1]),
             f"the library stand-in for sort_kv_tiles differs at {what}")
    del lib, want
    ms = _events_ms(lambda: skv.sort_kv_tiles(t, pay, tile=block,
                                              alternate=True), 3)
    plain_ms = _events_ms(lambda: skv.sort_kv_tiles_ref(t, pay, tile=block,
                                                        alternate=True), 3)
    library_ms = _events_ms(library, 3)
    times["sort_kv_tiles"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                  library_ms=library_ms,
                                  kernel_phase_launches=skv.LAUNCHES - before)
    print(f"kernel times: sort_kv_tiles at {what}, {block}-pair blocks: "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (stable "
          f"torch.sort of even blocks up, odd blocks down, + gather) "
          f"{library_ms:.4f} ms, bound {bound:.4f} ms, "
          f"max_abs_err={err}, {skv.LAUNCHES - before} launches [{card}]")
    for tile in skv.KERNEL_TILES[:-1]:   # the smaller blocks, printed only
        got = skv.sort_kv_tiles(t, pay, tile=tile, alternate=True)
        want = skv.sort_kv_tiles_ref(t, pay, tile=tile, alternate=True)
        err = max(_err(got[0], want[0]), _err(got[1], want[1]))
        del got, want
        _require(not err, f"sort_kv_tiles differs from its plain version at "
                 f"{what}, {tile}-pair blocks")
        tile_ms = _events_ms(lambda tile=tile: skv.sort_kv_tiles(
            t, pay, tile=tile, alternate=True), 3)
        print(f"kernel times: sort_kv_tiles at {what}, {tile}-pair blocks: "
              f"{tile_ms:.4f} ms (printed, not reported), max_abs_err={err} "
              f"[{card}]")
    del t, pay
    torch.cuda.empty_cache()
    return total


def _plain_matches(r: Relation, s: Relation) -> int:
    """The join's match count by two torch.searchsorted calls of S's keys
    into R's sorted keys."""
    rs = torch.sort(r.keys).values
    return int((torch.searchsorted(rs, s.keys, right=True)
                - torch.searchsorted(rs, s.keys)).sum())


def _counters_runs(dev, card, rate, total) -> None:
    """cli.main with --counters --throughput on the headline join and the
    atomic scatter build: the default events, bandwidth under the copy
    rate, tuplesPerSecond = n / time; then --profile on the headline join,
    whose trace must name K1's kernel."""
    n = 1 << LOG2_N
    headline = ["--algo", "htm", "--dataDistr", "local_shuffle", "--rSize",
                str(n)]
    scatter = ["--algo", "atomic", "--backend", "xla", "--noProbe",
               "--dataDistr", "shuffle", "--rSize", str(n)]
    for argv, expect in ((headline, {"fused_sort_count": 1}),
                         (scatter, {"claim_insert": 1})):
        argv = argv + ["--counters", "--throughput"]
        res = {}
        counts = _run_path(f"cli {' '.join(argv)}",
                           lambda: len(res.setdefault(
                               "out", _cli_lines(argv, dev))), expect, card)
        for k, v in counts.items():
            total[k] += v
        line, rep = res["out"]
        events = line.get("counters", {})
        secs = (line["hashBuildTimeInMicroseconds"]
                + (line.get("probeTimeInMicroseconds") or 0.0)) * 1e-6
        want_n = n + (n if line.get("probeTimeInMicroseconds") else 0)
        print(f"measure: {' '.join(argv)}: counters {json.dumps(events)}; "
              f"throughput {json.dumps(rep)}; copy rate {rate:.1f} GB/s "
              f"[{card}]")
        _require(events and all(
            set(e) == {"flops", "bytes", "intensity", "bandwidth"}
            and 0 < e["bandwidth"] <= rate * 1.05 for e in events.values()),
            f"counters of {argv}: {events} (copy rate {rate} GB/s)")
        _require(line["inputSum"] == line["outputSum"] and
                 rep["numTuples"] == want_n and
                 abs(rep["tuplesPerSecond"] - want_n / secs)
                 <= 1e-9 * rep["tuplesPerSecond"],
                 f"throughput line of {argv}: {rep} for {line}")
    with tempfile.TemporaryDirectory() as tmp:
        argv = headline + ["--profile", tmp]
        counts = _run_path(f"cli {' '.join(argv)}",
                           lambda: _cli_line(argv, dev)["totalMatches"],
                           {"fused_sort_count": 1}, card)
        for k, v in counts.items():
            total[k] += v
        files = glob.glob(os.path.join(tmp, "*.pt.trace.json*"))
        _require(len(files) == 1, f"--profile wrote {files}")
        opener = gzip.open if files[0].endswith(".gz") else open
        with opener(files[0], "rt") as f:
            text = f.read()
        print(f"measure: --profile trace {os.path.basename(files[0])}: "
              f"{len(text)} bytes, names fused_sort_count_kernel: "
              f"{'fused_sort_count_kernel' in text}")
        _require("fused_sort_count_kernel" in text,
                 "the headline join's trace does not name K1's kernel")


def _harness_grids(dev, card, total, grids, phase) -> dict:
    """Each grid of ``grids`` (name -> (pipeline depth, the kernels its
    plans must launch)) at 2^27 through run_grid into a temporary --outDir;
    every line conserves the key sum, and every line that probes is exact
    against a plain count of the same relations, made anew from the grid's
    seeds.  Returns each grid's lines."""
    out = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for name, (depth, expect) in grids.items():
            res = {}
            counts = _run_path(
                f"harness {name} 2^{LOG2_N} --pipelineDepth {depth}",
                lambda: len(res.setdefault("lines", run_grid(
                    name, scale=LOG2_N, reps=1, out_dir=out_dir, echo=False,
                    pipeline_depth=depth, device=dev))), expect, card)
            for k, v in counts.items():
                total[k] += v
            runner.clear_cache()
            torch.cuda.empty_cache()
            lines = [json.loads(x) for x in res["lines"]]
            bad = []
            for cfg, d in zip(GRIDS[name](LOG2_N), lines):
                ok = d["inputSum"] == d["outputSum"]
                want = None
                if "totalMatches" in d:
                    r, s = build_relations(cfg, dev)
                    want = _plain_matches(r, s)
                    del r, s
                    ok = ok and d["totalMatches"] == want
                if depth > 1 and d.get("resorted") is False:
                    ok = ok and d.get("pipelineDepth") == depth \
                        and "singleRunTimeInMicroseconds" in d
                if not ok:
                    bad.append((cfg, d, want))
            torch.cuda.empty_cache()
            builds = [d["hashBuildTimeInMicroseconds"] for d in lines]
            repaired = sum(d.get("resorted") is True for d in lines)
            probing = sum("totalMatches" in d for d in lines)
            log = os.path.join(out_dir, f"{name}_log1")
            print(f"{phase}: harness {name} 2^{LOG2_N}: {len(lines)} points, "
                  f"{len(lines) - len(bad)} exact, {repaired} repaired, "
                  f"{probing} probing; hashBuildTimeInMicroseconds "
                  f"{min(builds):.1f}..{max(builds):.1f}; {name}_log1 "
                  f"written: {os.path.exists(log)} [{card}]")
            _require(not bad and len(lines) == len(list(GRIDS[name](LOG2_N)))
                     and os.path.exists(log), f"harness {name}: {bad[:3]}")
            out[name] = lines
    return out


def _chunk_sweeps(dev, card) -> None:
    rows = chunk_sweep(LOG2_N, device=dev)
    _require([r["chunkSize"] for r in rows] == [1 << i for i in range(13)]
             and all(r["maxFailureFraction"] == 0.0 for r in rows),
             f"chunk sweep at 2^{LOG2_N}: {rows}")
    card_rows = chunk_sweep(20, device=dev)
    cpu_rows = chunk_sweep(20, device="cpu")
    same = [_untimed(r) for r in card_rows] == [_untimed(r) for r in cpu_rows]
    print(f"measure: chunk sweep 2^{LOG2_N}: 13 rows, build "
          f"{rows[0]['buildTimeUsecs']:.1f} us; 2^20 rows equal the CPU's: "
          f"{same} (card build {card_rows[0]['buildTimeUsecs']:.1f} us) "
          f"[{card}]")
    _require(same, f"chunk sweep 2^20: card {card_rows} != CPU {cpu_rows}")


def _persistence(dev, card) -> None:
    m = 1 << 24
    rel = Relation(shuffled_keys(m, 5, dev), sorted_keys(m, dev))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "r.npz")
        t0 = time.perf_counter()
        persist.save_relation(rel, path)
        back = persist.load_relation(path, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        same = back.keys.device == rel.keys.device and \
            torch.equal(back.keys, rel.keys) and \
            torch.equal(back.payloads, rel.payloads)
        cfg = JoinConfig(r_size=m, data_distr=Distribution.SHUFFLE, seed=5)
        calls = []

        def generate():
            calls.append(1)
            return Relation(shuffled_keys(m, 5, dev))

        # no device given: a miss and a hit both land on the card
        a = persist.cached_relation(cfg, "r", tmp, generate)
        b = persist.cached_relation(cfg, "r", tmp, generate)
        cached = len(calls) == 1 and torch.equal(a.keys, b.keys) and \
            a.keys.device == b.keys.device == rel.keys.device
    print(f"measure: persistence 2^24 keys + payloads: .npz round trip "
          f"equal: {same} ({secs:.3f} s); cached_relation generated "
          f"{len(calls)} time(s) over two calls, both on "
          f"{a.keys.device}/{b.keys.device} [{card}]")
    _require(same and cached, "persistence round trip or cache failed")


def _native(dev, card, total) -> None:
    """The native generator's keys through the headline join, where its
    library loads and runs on this host (a host library built for its own
    CPU: a child process tries it first)."""
    n = 1 << LOG2_N
    if not native.available():
        print("measure: native: libhtmdatagen.so does not load here; the "
              "native generator (a host library) is skipped")
        return
    probe = subprocess.run(
        [sys.executable, "-c",
         "from htm_hashjoin_tpu_torch.data import native; "
         "assert native.checksum(native.local_shuffled_keys(4096, 16))"
         " == 4096 * 4097 // 2"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    if probe.returncode:
        print(f"measure: native: libhtmdatagen.so loads but fails on this "
              f"host (exit {probe.returncode}); skipped")
        return
    t0 = time.perf_counter()
    keys = native.local_shuffled_keys(n, WINDOW)
    gen_s = time.perf_counter() - t0
    rkeys = torch.from_numpy(keys).to(dev)
    skeys = sorted_keys(n, dev)
    del keys
    res = {}
    counts = _run_path(
        f"native local_shuffled_keys(2^{LOG2_N}, {WINDOW}) joined",
        lambda: res.setdefault("out", bb.banded_join_pipelined(
            rkeys, skeys, tile=TILE, locality_window=WINDOW,
            unique_both=True)), {"fused_sort_count": 1}, card)
    for k, v in counts.items():
        total[k] += v
    out = res["out"]
    print(f"measure: native: generated in {gen_s:.3f} s on the host; "
          f"matches {out.matches}, sums {out.input_sum} / {out.output_sum}"
          f", violations {out.violations}, resorted {out.resorted}")
    _require(out.matches == n and
             out.input_sum == out.output_sum == n * (n + 1) // 2,
             "the native keys' join is not exact")
    del rkeys, skeys
    torch.cuda.empty_cache()


def _measurement(dev, card) -> dict:
    """Phase 12: the testbed, the CLI's counters, throughput and trace, the
    harness grids, the chunk sweep, persistence and the native generator."""
    t0 = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    bw = memory_bandwidth(LOG2_N, device=dev)
    print(f"measure: testbed 2^{LOG2_N} int32 copy: gbps {bw['gbps']:.1f} "
          f"(chain of {bw['chain']}, {bw['bestTimeUsecs']:.2f} us a copy), "
          f"gbpsSingleFenced {bw['gbpsSingleFenced']:.1f} "
          f"({bw['singleFencedTimeUsecs']:.2f} us) [{card}]")
    _require(0 < bw["gbps"] <= HBM_BYTES_PER_S / 1e9 * 1.05,
             f"testbed copy rate {bw['gbps']} GB/s")
    _counters_runs(dev, card, bw["gbps"], total)
    _harness_grids(dev, card, total, HARNESS, "measure")
    _chunk_sweeps(dev, card)
    _persistence(dev, card)
    _native(dev, card, total)
    torch.cuda.empty_cache()
    print(f"measure: phase 12 took {time.perf_counter() - t0:.1f} s [{card}]")
    return total


def _dist_cfgs(n: int) -> dict:
    """The phase's four configurations at n keys a side: flat and
    hierarchical on shuffled keys, and on zipf(1.2) R over n/16 keys the
    skew plan and the forced repair."""
    zipf = dict(data_distr=Distribution.ZIPF, distinct_keys=n // 16,
                zipf_param=1.2)
    base = dict(algo=Algo.RADIX, r_size=n)
    return {
        "flat (8,) shuffle": JoinConfig(**base, mesh_shape=(8,),
                                        data_distr=Distribution.SHUFFLE),
        "hierarchical (2, 4) shuffle": JoinConfig(
            **base, mesh_shape=(2, 4), data_distr=Distribution.SHUFFLE),
        "skew plan (8,) zipf": JoinConfig(**base, mesh_shape=(8,),
                                          skew_handling=True, **zipf),
        "forced repair (2, 4) zipf": JoinConfig(
            **base, mesh_shape=(2, 4), shuffle_capacity_factor=1.0, **zipf),
    }


def _dist_line(name, fn, card, total) -> dict:
    """One distributed join through _run_path (counts 0 just before it,
    read just after); its JSON line as a dict."""
    res = {}
    counts = _run_path(name, lambda: res.setdefault("d", fn()).get(
        "totalMatches"), {}, card)
    for k, v in counts.items():
        total[k] += v
    return res["d"]


def _distributed(dev, card) -> dict:
    """Phase 13: the distributed join, eight shards on the card through a
    device-mapping file (``8 0 1 2 3 4 5 6 7``, named in
    $HTM_DEVICE_MAPPING for this phase only).  The shards run one after
    another, so every wall here is the total work of the sharded
    algorithm on one card, not scaling."""
    t0 = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    n = 1 << LOG2_N
    gauss = n * (n + 1) // 2
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "device-mapping.txt")
        with open(path, "w") as f:
            f.write("8 0 1 2 3 4 5 6 7\n")
        with mapping_env(path):
            # the CLI, flat and hierarchical, on 2^27 shuffled keys
            for shape in ("8", "2,4"):
                argv = ["--algo", "radix", "--rSize", str(n), "--dataDistr",
                        "shuffle", "--meshShape", shape]
                d = _dist_line(f"cli {' '.join(argv)}",
                               lambda: _cli_line(argv, dev), card, total)
                print(f"distributed: cli --meshShape {shape}: "
                      f"{json.dumps(d)} [{card}]")
                _require(d["algo"] == "dist_radix" and d["totalMatches"] == n
                         and d["inputSum"] == d["outputSum"] == gauss
                         and d["droppedR"] == d["droppedS"] == 0
                         and d["repairedR"] == d["repairedS"] == 0
                         and d["nDevices"] == 8
                         and d["hierarchical"] == ("," in shape),
                         f"cli --meshShape {shape}: {d}")
                torch.cuda.empty_cache()
            _distributed_zipf(dev, card, total, n)
            fcfg = _dist_cfgs(n)["flat (8,) shuffle"]
            r, s = build_relations(fcfg, dev)
            _profile(f"distributed (8,) shuffle 2^{LOG2_N}",
                     lambda: distributed_join(r, s, fcfg), card)
            del r, s
            torch.cuda.empty_cache()
            pt = scaling.scaling_point((8,), n, n, reps=2, device=dev)
            print(f"distributed: scaling_point((8,), 2^{LOG2_N}, "
                  f"2^{LOG2_N}) pk x sorted, best of 2: exchange "
                  f"{pt['exchangeTimeUs'] / 1e3:.3f} ms, join "
                  f"{pt['joinTimeUs'] / 1e3:.3f} ms, repair "
                  f"{pt['repairTimeUs'] / 1e3:.3f} ms, total "
                  f"{pt['totalTimeUs'] / 1e3:.3f} ms, exact {pt['exact']} "
                  f"[{card}]")
            _require(pt["exact"] and not pt["repairFired"],
                     f"scaling_point at 2^{LOG2_N}: {pt}")
            torch.cuda.empty_cache()
            _distributed_small(dev, card, total)
            dryrun_multichip(8, device=dev)
            print("distributed: dryrun_multichip(8) on the card: ok")
            lines = scaling.scaling_sweep(os.path.join(tmp, "scaling_log"),
                                          reps=2, echo=False, device=dev)
            print(scaling.summary(lines, scaling._available_devices(dev)),
                  end="")
            print(f"distributed: scaling sweep: {len(lines)} points, "
                  f"{sum(p['exact'] for p in lines)} exact [{card}]")
            _require(len(lines) == 36 and all(p["exact"] for p in lines),
                     "the scaling sweep is not exact")
    torch.cuda.empty_cache()
    print(f"distributed: phase 13 took {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    return total


def _distributed_zipf(dev, card, total, n) -> None:
    """zipf(1.2) R over 2^23 keys x FK S at 2^27: the skew plan through the
    CLI, the forced repair on (8,) and (2, 4), the reported drops without
    repair, and a (1,) mesh (the card itself, no mapping) against the
    single-device radix join, each held to a plain count."""
    argv = ["--algo", "radix", "--rSize", str(n), "--dataDistr", "zipf",
            "--distinctKeys", str(n // 16), "--zipfParam", "1.2",
            "--skewHandling", "--meshShape", "8"]
    d = _dist_line(f"cli {' '.join(argv)}", lambda: _cli_line(argv, dev),
                   card, total)
    cfg, _ = cli.parse_args(argv)
    r, s = build_relations(cfg, dev)
    exact = _plain_matches(r, s)
    print(f"distributed: cli --skewHandling zipf: {json.dumps(d)}; exact "
          f"{exact} [{card}]")
    _require(d["totalMatches"] == exact and d["hotKeys"] > 0
             and d["inputSum"] == d["outputSum"]
             and d["droppedR"] == d["droppedS"] == 0,
             f"the skew plan at 2^{LOG2_N}: {d}")
    _profile(f"distributed (8,) skew plan zipf 2^{LOG2_N}",
             lambda: distributed_join(r, s, cfg), card)
    plain = dataclasses.replace(cfg, skew_handling=False,
                                shuffle_capacity_factor=1.0)
    for shape in ((8,), (2, 4)):
        rcfg = dataclasses.replace(plain, mesh_shape=shape)
        d = _dist_line(f"distributed_join {shape} zipf capacity 1.0",
                       lambda: distributed_join(r, s, rcfg).to_dict(), card,
                       total)
        print(f"distributed: forced repair {shape}: {json.dumps(d)} "
              f"[{card}]")
        _require(d["repairedR"] + d["repairedS"] > 0
                 and d["droppedR"] == d["droppedS"] == 0
                 and d["totalMatches"] == exact
                 and d["inputSum"] == d["outputSum"],
                 f"forced repair {shape}: {d}")
    rcfg = dataclasses.replace(plain, mesh_shape=(2, 4))
    _profile(f"distributed (2, 4) forced repair zipf 2^{LOG2_N}",
             lambda: distributed_join(r, s, rcfg), card)
    drop = distributed_join(r, s, dataclasses.replace(
        plain, mesh_shape=(8,), residual_repair=False))
    print(f"distributed: residual_repair=False (8,): {drop.to_json_line()} "
          f"[{card}]")
    _require(drop.extra["droppedR"] + drop.extra["droppedS"] > 0
             and drop.totalMatches < exact, "no drops without the repair")
    with mapping_env(None):
        one = distributed_join(r, s, dataclasses.replace(plain,
                                                         mesh_shape=(1,)))
    single = DISPATCH["radix"](r, s, dataclasses.replace(plain,
                                                         mesh_shape=()))
    print(f"distributed: (1,) mesh {one.totalMatches} ("
          f"{one.hashBuildTimeInMicroseconds:.1f} us), DISPATCH radix "
          f"{single.totalMatches} [{card}]")
    _require(one.totalMatches == single.totalMatches == exact
             and one.extra["nDevices"] == 1, "the (1,) mesh differs")
    del r, s
    torch.cuda.empty_cache()


def _distributed_small(dev, card, total) -> None:
    """The four configurations at 2^20, the card's line equal to the
    CPU's on the same relations but for the times; then reference fault 9
    at 2^22: R holding key 0 and S holding INT32_MAX join exactly."""
    for name, cfg in _dist_cfgs(1 << 20).items():
        r, s = build_relations(cfg, dev)
        card_line = _dist_line(f"distributed_join 2^20 {name}",
                               lambda: distributed_join(r, s, cfg).to_dict(),
                               card, total)
        cpu_line = distributed_join(Relation(r.keys.cpu()),
                                    Relation(s.keys.cpu()), cfg).to_dict()
        exact = _plain_matches(r, s)
        print(f"distributed: 2^20 {name}: card equals the CPU: "
              f"{_untimed(card_line) == _untimed(cpu_line)}; matches "
              f"{card_line['totalMatches']} (exact {exact}) [{card}]")
        _require(_untimed(card_line) == _untimed(cpu_line)
                 and card_line["totalMatches"] == exact,
                 f"2^20 {name}: card {card_line}, CPU {cpu_line}")
        del r, s
    m = 1 << 22
    r = torch.arange(1, m + 1, dtype=torch.int32, device=dev)
    s = r.clone()
    r[100] = 0
    s[200] = MAXI32
    got = distributed_join(Relation(r), Relation(s),
                           JoinConfig(algo=Algo.RADIX, r_size=m,
                                      mesh_shape=(8,)))
    exact = _plain_matches(Relation(r), Relation(s))
    print(f"distributed: fault 9 at 2^22 (R key 0, S key INT32_MAX): "
          f"matches {got.totalMatches}, exact {exact}, sums "
          f"{got.inputSum} / {got.outputSum} [{card}]")
    _require(got.totalMatches == exact == m - 2 and got.conserved,
             "padding matched a real key")
    del r, s
    torch.cuda.empty_cache()


def _entry_step(dev, card, total) -> None:
    """entry() on the card against the CPU's and the expected numbers (the
    claim kernel once, for the retry rounds, and the probe kernel once, its
    only kernels), then ``python -m htm_hashjoin_tpu_torch.entry``'s
    main: the step and dryrun_multichip(8) under a mapping of its own."""
    fn, args = entry(dev)
    res = {}
    # the retry rounds and the bucket probe, nothing else
    expect = {"claim_insert": 1, "hash_probe": 1}
    counts = _run_path("entry() 2^16", lambda: res.setdefault(
        "out", tuple(int(x) for x in fn(*args))), expect, card)
    for k, v in counts.items():
        total[k] += v
    cpu_fn, cpu_args = entry("cpu")
    cpu = tuple(int(x) for x in cpu_fn(*cpu_args))
    n = 1 << 16
    want = (n, n * (n + 1) // 2, 0)
    print(f"experiments: entry() on the card {res['out']}, on the CPU {cpu}, "
          f"expected {want} (matches, outputSum, failed inserts) [{card}]")
    _require(res["out"] == cpu == want and
             all(v == expect.get(k, 0) for k, v in counts.items()),
             f"entry(): card {res['out']}, CPU {cpu}, expected {want}, "
             f"launches {counts}")
    entry_main()


def _dial(dev, card, total) -> None:
    """The adaptive dial experiment at its defaults (2^26, true window 64,
    declared 2^20, cheap 4, 3 reps): each plan's warm median and launches;
    whether adaptive beats both fixed plans is printed, not required."""
    res = {}
    counts = _run_path(
        "adaptive_dial_bench 2^26 (window 64, declared 2^20, cheap 4)",
        lambda: len(res.setdefault("lines", dial.measure(device=dev,
                                                         echo=False))),
        {"fused_sort_count": 1, "global_sort_tiles": 1,
         "banded_count_narrow": 1}, card)
    for k, v in counts.items():
        total[k] += v
    for d in res["lines"]:
        print(f"experiments: dial {json.dumps(d)}")
    out = dial.summary(res["lines"])
    for name, d in out["plans"].items():
        print(f"experiments: dial {name}: warm median "
              f"{d['warmMedianUs']:.1f} us, best {d['bestUs']:.1f} us, "
              f"launches a warm rep {d['launches']} [{card}]")
    print(f"experiments: dial: adaptive beats both fixed plans: "
          f"{out['adaptiveBeatsBoth']} [{card}]")
    torch.cuda.empty_cache()


def _crossover(dev, card, total) -> None:
    """The radix crossover at its defaults (2^20..2^27, 3 reps, 14 bits):
    every output checked as a multiset and for its order by the module;
    the multipass/sort ratio per size."""
    res = {}
    counts = _run_path(
        f"radix_crossover 2^{','.join(map(str, rx.SIZES))}",
        lambda: len(res.setdefault("lines", rx.crossover(
            rx.SIZES, rx.REPS, rx.RADIX_BITS, dev, echo=False))),
        {"global_sort_tiles": 1, "sort_tiles": 1, "scatter_tiles": 1}, card)
    for k, v in counts.items():
        total[k] += v
    for d in res["lines"]:
        print(f"experiments: crossover {json.dumps(d)} [{card}]")
    print("experiments: crossover multipass/sort: " + ", ".join(
        f"2^{lg} {r:.3f}" for lg, r in rx.ratios(res["lines"]).items())
        + f" [{card}]")
    torch.cuda.empty_cache()


def _experiments(dev, card) -> dict:
    """Phase 14: entry(), the two planner experiments, the eight grids no
    other phase runs, and the source paper's motivation comparison."""
    t0 = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    _entry_step(dev, card, total)
    _dial(dev, card, total)
    _crossover(dev, card, total)
    lines = _harness_grids(dev, card, total, GRIDS_BUILD, "experiments")
    print("experiments: the motivation comparison from this phase's one rep "
          "(a grid's first point carries one-time costs; harness.report "
          "gives the medians over the reps of `harness all`)")
    for line in report.motivation_lines(report.motivation_ratios(
            [lines["motivation"]])):
        print(f"experiments: {line} [{card}]")
    print(f"experiments: phase 14 took {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    torch.manual_seed(0)
    dev = torch.device("cuda")
    card = _smi("name,power.limit")
    print(f"device: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")

    # 2. build
    path, seconds, report = _build.build()
    _build.load_library()
    usage = _build.kernel_usage(report)
    print(f"build: nvcc {seconds:.2f} s -> {path.name}; " + "; ".join(
        f"{name}: {regs} registers, spill stores {st} bytes, loads {ld} "
        f"bytes" for name, (regs, st, ld) in usage.items()))
    k7a = [u for name, u in usage.items() if name.startswith("sort_kv_kernel")]
    _require(len(k7a) == len(skv.KERNEL_TILES) and
             not any(st or ld for _, st, ld in k7a),
             "ptxas reports spills for K7a (or no K7a kernel)")

    # 3. kernel against its plain version, a few tiles per case
    n = 4 * TILE
    dup = torch.repeat_interleave(torch.arange(1, n // 2 + 1, dtype=torch.int32,
                                               device=dev), 2)
    dup_r = dup[torch.sort(torch.arange(n, device=dev)
                           + torch.randint(0, 8, (n,), device=dev),
                           stable=True).indices]
    heavy_s = torch.from_numpy(np.sort(np.concatenate(
        [np.arange(1, n + 1, dtype=np.int32),
         np.full(6000, 100, np.int32)]))).to(dev)
    cases = [
        ("unique w16 blocks", local_shuffled_keys(n, 16, 1, dev),
         sorted_keys(n, dev), "blocks", 16),
        ("unique w512 blocks", local_shuffled_keys(n, 512, 3, dev),
         sorted_keys(n, dev), "blocks", 512),
        ("padded last tile w4 oddeven", local_shuffled_keys(n - 77, 4, 2, dev),
         sorted_keys(n - 77, dev), "oddeven", 4),
        ("shuffled bitonic", torch.randperm(n, device=dev).to(torch.int32) + 1,
         sorted_keys(n, dev), "bitonic", 1),
        ("duplicates w8 blocks", dup_r, dup, "blocks", 8),
        ("underestimated window w64 oddeven4",
         local_shuffled_keys(n, 64, 0, dev), sorted_keys(n, dev), "oddeven", 4),
        ("6000-copy S run", local_shuffled_keys(n, 8, 7, dev), heavy_s,
         "oddeven", 8),
    ]
    errs = dict.fromkeys(KERNELS, 0)
    for name, rkeys, skeys, method, passes in cases:
        err, viols, flagged = _check_kernel(name, rkeys, skeys, method,
                                            passes)
        errs["fused_sort_count"] = max(errs["fused_sort_count"], err)
        if name.startswith("underestimated"):
            _require(viols > 0, "the underestimated window left no inversions")
        if name.startswith("6000"):
            _require(flagged > 0, "the 6000-copy run did not flag its tile")
    del cases, dup, dup_r, heavy_s
    _check_k1_kinds(dev, errs)
    _check_other_kernels(dev, errs)
    _check_big_sorts(dev, errs)

    # 4. the main path at 2^27, counting K1 and prepass launches
    n = 1 << LOG2_N
    expect_sum = n * (n + 1) // 2
    rkeys = local_shuffled_keys(n, WINDOW, 0, dev)
    skeys = sorted_keys(n, dev)
    s2d = bb.prepare_probe_side(skeys, TILE)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out = bb.banded_join_pipelined(rkeys, skeys, tile=TILE,
                                   locality_window=WINDOW, unique_both=True,
                                   s2d=s2d)
    first_s = time.perf_counter() - t0
    main_counts = _counts()
    launches = main_counts["fused_sort_count"]
    print(f"main: 2^{LOG2_N} build+probe, window {WINDOW}, tile {TILE}: "
          f"{out} (first call {first_s:.3f} s), K1 launches={launches}, "
          f"prepass launches={tmm.LAUNCHES}")
    _require(out.matches == n, f"expected {n} matches, got {out.matches}")
    _require(out.output_sum == out.input_sum == expect_sum,
             "conservation violated")
    _require(out.violations == 0 and out.overflow_tiles == 0,
             "violations or flagged tiles on the main path")
    _require(launches >= 1 and tmm.LAUNCHES >= 1,
             "the main path did not launch K1 and its prepass")

    m = 1 << 24
    before = fsc.LAUNCHES
    retry = bb.banded_join_pipelined(local_shuffled_keys(m, 64, 0, dev),
                                     sorted_keys(m, dev), tile=TILE,
                                     locality_window=4)
    print(f"main: 2^24 retry (window-64 data, locality_window=4): {retry}, "
          f"K1 launches={fsc.LAUNCHES - before}")
    _require(retry.resorted and retry.violations > 0 and retry.matches == m
             and retry.output_sum == m * (m + 1) // 2,
             "the abort -> retry run did not retry or lost matches")
    _require(fsc.LAUNCHES - before == 2, "the retry did not relaunch K1")

    # 5. times: K1 (as the main path and as the retry run it), the
    # prepass, the device chain and its split, then bench
    r_flat = bb.to_tiles(rkeys, TILE)
    _, _, row_off, rows_needed = bb.band_rows(r_flat, skeys, TILE)
    args = (r_flat, s2d, row_off, rows_needed)
    k1 = {}
    for method, passes in (("blocks", WINDOW), ("bitonic", 1)):
        kw = dict(tile=TILE, method=method, passes=passes)
        got = fsc.fused_sort_count(*args, **kw)
        want = fsc.fused_sort_count_ref(*args, **kw)
        err = _max_abs_err(got, want)
        _require(not err, f"K1 {method} differs from its plain version at "
                 f"2^{LOG2_N}")
        errs["fused_sort_count"] = max(errs["fused_sort_count"], err)
        bound = _bound_ms(args, got)
        del got, want
        ms = _events_ms(lambda: fsc.fused_sort_count(*args, **kw), 20)
        plain = _events_ms(lambda: fsc.fused_sort_count_ref(*args, **kw), 3)
        k1[method] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                          library_ms=None)
        print(f"times: K1 {method} at 2^{LOG2_N}: {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bound:.4f} ms, max_abs_err={err} "
              f"[{card}]")
    got = tmm.tile_minmax(r_flat, TILE)
    want = tmm.tile_minmax_ref(r_flat, TILE)
    err = max(_err(got[0], want[0]), _err(got[1], want[1]))
    _require(not err, "the prepass differs from its plain version at 2^27")
    pre_bound = _bound_ms((r_flat,), got)
    pre_ms = _events_ms(lambda: tmm.tile_minmax(r_flat, TILE), 20)
    pre_plain = _events_ms(lambda: tmm.tile_minmax_ref(r_flat, TILE), 5)
    print(f"times: prepass tile_minmax at 2^{LOG2_N}: {pre_ms:.4f} ms, plain "
          f"(amin, where, amax) {pre_plain:.4f} ms, bound {pre_bound:.4f} ms,"
          f" max_abs_err={err} [{card}]")

    def chain():
        return bb.enqueue_banded_join(rkeys, skeys, tile=TILE,
                                      locality_window=WINDOW,
                                      unique_both=True, s2d=s2d)

    join_ms = _events_ms(chain, 10)
    ops = _device_ops(chain)
    part = {"prepass": "tile_minmax_kernel", "K1": "fused_sort_count_kernel"}
    split = {k: sum(t for name, t in ops if name == v)
             for k, v in part.items()}
    split["searchsorted"] = sum(t for name, t in ops if "searchsorted" in name)
    others = [(name, t) for name, t in ops if name not in part.values()]
    split["rest"] = sum(t for name, t in others) - split["searchsorted"]
    print(f"times: device chain of enqueue_banded_join at 2^{LOG2_N}: "
          f"{join_ms:.4f} ms a call (CUDA events, 10 calls); one profiled "
          f"call: {'; '.join(f'{k} {v:.4f} ms' for k, v in split.items())};"
          f" the {len(others)} other ops: "
          f"{', '.join(f'{name} {t * 1e3:.1f} us' for name, t in others)} "
          f"[{card}]")
    _require(all(t < 0.1 for _, t in others),
             "an op other than the prepass and K1 took 0.1 ms or more on the "
             "headline chain (one read of R takes 0.16 ms)")
    del args, r_flat, row_off, rows_needed, rkeys, skeys, s2d
    torch.cuda.empty_cache()
    rec = bench.measure(log2_n=LOG2_N, window=WINDOW, reps=3, pipe=5)
    print(f"times: bench {json.dumps(rec)} "
          f"sustained={2 * n / rec['seconds'] / 1e6:.1f} Mtuples/s "
          f"single={2 * n / rec['single_run_seconds'] / 1e6:.1f} Mtuples/s "
          f"[{card}; {_smi('clocks.sm,power.draw,temperature.gpu')}]")

    times = {"fused_sort_count": k1["blocks"]}

    # 6-7. every other path at 2^27, then K2-K5 at their paths' shapes
    counts = _paths(dev, card, errs, times)
    counts["fused_sort_count"] += main_counts["fused_sort_count"]
    # 8-14. K6 and the multipass radix join, the CLI's paths, the hash
    # joins, K7 and the Wisconsin multijoin, the measurement layer, the
    # distributed join, then entry() and the experiments
    for more in (_radix(dev, card, errs, times), _cli_paths(dev, card),
                 _hash_joins(dev, card, errs, times),
                 _wisconsin(dev, card, errs, times),
                 _measurement(dev, card), _distributed(dev, card),
                 _experiments(dev, card)):
        for k, v in more.items():
            counts[k] += v
    for name in KERNELS:
        if name in OFF_PATH:
            _require(counts[name] == 0 and
                     times[name]["kernel_phase_launches"] > 0,
                     f"{name} ran on a path or not at all ({OFF_PATH[name]})")
        else:
            _require(counts[name] > 0, f"no path launched {name}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": CSRC + src,
        "replaces": replaces, "launches": counts[name],
        "max_abs_err": errs[name], **times[name], "bound_by": "bytes"}
        for name, (_, src, replaces) in KERNELS.items()]}))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
