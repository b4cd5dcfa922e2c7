#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (htm_hashjoin_tpu_torch) on one GPU.

Phases, one line each:
  1. device   - the card's name and power limit (nvidia-smi);
  2. build    - nvcc builds the five kernels from htm_hashjoin_tpu_torch/csrc/
                (one nvcc process per source, all started together);
  3. kernel   - K1 (fused_sort_count) against its plain torch version on
                the card, on cases of a few tiles, exactly (integer outputs;
                counts only on tiles with zero inversions); then K2 (all four
                sorters), K3, K4 and K5 against theirs, exactly;
  4. main     - the headline join, 2^27 locality build + 2^27 sorted probe,
                through banded_join_pipelined with bench.py's asserts and a
                count of K1 launches; then the abort -> bitonic retry at 2^24;
  5. times    - sustained (5 joins per readback) and single-run throughput,
                and K1 against its plain version at 2^27 (held equal there too);
  6. path     - every other plan once at 2^27 keys a side (the heavy hitter
                at 2^24): build-only with and without locality, wide band,
                sort-first, the sort-first switch, the skewed probe with its
                repair, the heavy hitter's tagged count; exact answers, each
                kernel's launches (counts set to 0 just before each path, read
                just after) and the wall time;
  7. kernel times - K2-K5 at their paths' shapes against their plain
                versions (held equal there too);
  8. radix      - K6 against its plain version on cases of a few tiles
                (fanout 128 at tile 8192, empty runs, runs of many rows,
                three passes), exactly; the multipass radix join at 2^27
                (pk R x sorted S, 14 bits in two passes of 7) through
                radix_join, exact, with two K6 launches and its peak device
                memory, then build-only; K6 against its plain version at the
                2^27 pass-1 and pass-2 shapes, timed;
  9. cli        - the CLI in-process (cli.main) at --rSize 2^27, one line per
                path the planner chooses: adaptive -> htm (K1), adaptive ->
                radix on the engine's sort plan and on the sort route (held
                to a torch.unique count), mc PRO (PK x FK), htm --switchSniff
                -> radix; each line's counts, sums, path and kernels checked.
Then a JSON line of kernels and, last, {"ok": true, "device": {...}}.
Any failure raises: the script exits non-zero and prints no result.  With no
CUDA device it exits 1 at once.  Every 2^27 input is freed before the next
is made.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time

import numpy as np
import torch

from htm_hashjoin_tpu_torch import bench, cli
from htm_hashjoin_tpu_torch.config import Algo, Distribution, JoinConfig
from htm_hashjoin_tpu_torch.constants import MAXI32
from htm_hashjoin_tpu_torch.data.generators import (build_relations,
                                                    local_shuffled_keys,
                                                    pk_keys, shuffled_keys,
                                                    sorted_keys, zipf_keys)
from htm_hashjoin_tpu_torch.joins import banded_backend as bb
from htm_hashjoin_tpu_torch.joins.radix import radix_join
from htm_hashjoin_tpu_torch.ops import _build
from htm_hashjoin_tpu_torch.ops import banded_count as bc
from htm_hashjoin_tpu_torch.ops import banded_count_narrow as bcn
from htm_hashjoin_tpu_torch.ops import fused_sort_count as fsc
from htm_hashjoin_tpu_torch.ops import global_sort as gs
from htm_hashjoin_tpu_torch.ops import radix_kernels as rk
from htm_hashjoin_tpu_torch.ops import scatter_tiles as sct
from htm_hashjoin_tpu_torch.ops import sort_tiles as st

TILE = 8192
LOG2_N = 27
WINDOW = 16
CSRC = "htm_hashjoin_tpu_torch/csrc/"
JOIN_KERNELS = "htm_hashjoin_tpu/ops/pallas/join_kernels.py"
RADIX_KERNELS = "htm_hashjoin_tpu/ops/pallas/radix_kernels.py"
# name -> (wrapper module, CUDA source, the TPU kernel's pallas_call)
KERNELS = {
    "fused_sort_count": (fsc, "fused_sort_count.cu", f"{JOIN_KERNELS}:1068"),
    "sort_tiles": (st, "sort_tiles.cu", f"{JOIN_KERNELS}:238"),
    "global_sort_tiles": (gs, "global_sort.cu", f"{JOIN_KERNELS}:429"),
    "banded_count": (bc, "banded_count.cu", f"{JOIN_KERNELS}:1240"),
    "banded_count_narrow": (bcn, "banded_count_narrow.cu",
                            f"{JOIN_KERNELS}:889"),
    "scatter_tiles": (sct, "scatter_tiles.cu", f"{RADIX_KERNELS}:348"),
}


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _smi(fields: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _max_abs_err(kernel_out, plain_out) -> int:
    """Largest absolute difference over sorted keys, stats and flags, and
    over counts of tiles the sorter left without inversions (counts are
    defined only there)."""
    ks, kst, kc, kf = kernel_out
    ps, pst, pc, pf = plain_out
    exact = pst[:, 2] == 0
    diffs = [(ks.long() - ps.long()).abs(), (kst.long() - pst.long()).abs(),
             (kf.long() - pf.long()).abs(),
             torch.where(exact, (kc - pc).abs(), 0)]
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


def _reset_counts() -> None:
    for mod, _, _ in KERNELS.values():
        mod.LAUNCHES = 0


def _counts() -> dict:
    return {name: mod.LAUNCHES for name, (mod, _, _) in KERNELS.items()}


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
    cases = {"displaced w64, padded last tile":
             bb.to_tiles(local_shuffled_keys(n, 64, 5, dev), TILE),
             "duplicates, padded last tile":
             bb.to_tiles(_duplicates(n, dev, 1), TILE)}
    for case, keys in cases.items():
        for method, passes in (("bitonic", 1), ("bitonic_alt", 1),
                               ("blocks", 16), ("oddeven", 4)):
            kw = dict(tile=TILE, method=method, passes=passes)
            got = st.sort_tiles(keys, **kw)
            want = st.sort_tiles_ref(keys, **kw)
            err = max(_err(got[0], want[0]), _err(got[1], want[1]))
            errs["sort_tiles"] = max(errs["sort_tiles"], err)
            print(f"kernel: K2 {method} on {case}: inversions="
                  f"{int(want[1][:, 2].sum())}, max_abs_err={err}")
            _require(not err, f"K2 {method} differs from its plain version")
    for n in (4 * TILE + 77, (1 << 20) + 5):
        for kind, keys in (("permutation", shuffled_keys(n, 1, dev)),
                           ("duplicates", _duplicates(n, dev, 2))):
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

    args = (r_flat, s_pad, row_off, rows_needed)
    got = bcn.banded_count_narrow(*args, tile=TILE)
    want = bcn.banded_count_narrow_ref(*args, tile=TILE)
    k1 = fsc.fused_sort_count(*args, tile=TILE, method="bitonic")
    err = max(_err(got[0], want[0]), _err(got[1], want[1]))
    err_k1 = max(_err(got[0], k1[2]), _err(got[1], k1[3]))
    print(f"kernel: K5: flagged={int(want[1].sum())}, matches="
          f"{int(want[0].sum())}, max_abs_err={err} (against K1's count: "
          f"{err_k1})")
    _require(not err and not err_k1 and int(want[1].max()) == 1,
             "K5 differs from its plain version or from K1")
    errs["banded_count_narrow"] = max(errs["banded_count_narrow"], err)


def _run_path(name, fn, expect, card) -> dict:
    """Drive one path with every launch count set to 0 just before it and
    read just after; check its outcome and the kernels it must launch."""
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    print(f"path: {name}: {out}; launches "
          f"{ {k: v for k, v in counts.items() if v} }; wall {wall:.4f} s "
          f"[{card}]")
    for kernel, least in expect.items():
        _require(counts[kernel] >= least,
                 f"{name} launched {kernel} {counts[kernel]} times, "
                 f"expected at least {least}")
    return counts


def _time_pair(name, what, kernel_fn, plain_fn, errs, times, card, reps=10,
               keep=True):
    """Hold a kernel equal to its plain version at a path's shape, then time
    both with CUDA events; the first shape timed is the one reported
    (``keep=False`` prints a shape's times without reporting them)."""
    got, want = kernel_fn(), plain_fn()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(_err(g, w) for g, w in zip(got, want))
    errs[name] = max(errs[name], err)
    _require(not err, f"{name} differs from its plain version at {what}")
    del got, want
    ms = _events_ms(kernel_fn, reps)
    plain_ms = _events_ms(plain_fn, 3)
    if keep:
        times.setdefault(name, (ms, plain_ms))
    print(f"kernel times: {name} at {what}: {ms:.4f} ms, plain {plain_ms:.4f}"
          f" ms, max_abs_err={err} [{card}]")


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
    r_flat = bb.to_tiles(r, TILE)
    kw = dict(tile=TILE, method="blocks", passes=WINDOW)
    _time_pair("sort_tiles", f"2^{LOG2_N} blocks w16",
               lambda: st.sort_tiles(r_flat, **kw),
               lambda: st.sort_tiles_ref(r_flat, **kw), errs, times, card)
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
    kw = dict(tile=TILE, method="bitonic")
    _time_pair("sort_tiles", f"2^{LOG2_N} bitonic",
               lambda: st.sort_tiles(r, **kw),
               lambda: st.sort_tiles_ref(r, **kw), errs, times, card)
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
               errs, times, card)
    del r, sorted_flat, stats

    # sort-first: shuffled R sorted globally (K2 phase A + K3), then K5
    r = shuffled_keys(n, 3, dev)
    res = {}
    add(_run_path(
        "sort-first shuffled x sorted (presort, unique_both)",
        lambda: res.setdefault("out", bb.banded_join_pipelined(
            r, s, tile=TILE, presort=True, unique_both=True, s2d=s2d)),
        {"sort_tiles": 1, "global_sort_tiles": 1, "banded_count_narrow": 1},
        card))
    out = res["out"]
    _require(out.matches == n and out.overflow_tiles == 0
             and out.output_sum == out.input_sum == gauss,
             f"sort-first: {out}")
    padded = bb.to_tiles_pow2(r, TILE)
    _time_pair("global_sort_tiles", f"2^{LOG2_N} shuffled (K2 phase A + K3)",
               lambda: gs.global_sort_tiles(padded, tile=TILE),
               lambda: gs.global_sort_ref(padded), errs, times, card, reps=5)
    r_sorted = gs.global_sort_tiles(padded, tile=TILE)
    mins, maxs, _ = st.tile_stats(r_sorted, TILE)
    row_off, rows_needed = bb._rows(*bb._slice_offsets(s, mins, maxs))
    _time_pair("banded_count_narrow", f"2^{LOG2_N} sort-first",
               lambda: bcn.banded_count_narrow(r_sorted, s2d, row_off,
                                               rows_needed, tile=TILE),
               lambda: bcn.banded_count_narrow_ref(r_sorted, s2d, row_off,
                                                   rows_needed, tile=TILE),
               errs, times, card)
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
    del r, s

    # heavy hitter: 2^24 copies of one key a side, 2^48 pairs
    m = 1 << (LOG2_N - 3)
    hot = torch.full((m,), 12345, dtype=torch.int32, device=dev)
    res = {}
    add(_run_path(
        "heavy hitter 2^24 x 2^24 copies (presorted, tagged count)",
        lambda: res.setdefault("out", bb.banded_join_pipelined(
            hot, hot, tile=TILE, presorted=True)),
        {"global_sort_tiles": 1}, card))
    out = res["out"]
    _require(out.matches == m * m and out.resorted,
             f"heavy hitter: {out}")
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    res = {}
    counts = _run_path(
        "multipass radix build-only (radix_join, no probe side)",
        lambda: res.setdefault("m", radix_join(r, None, cfg)).to_json_line(),
        {"scatter_tiles": 2, "sort_tiles": 3}, card)
    _require(res["m"].inputSum == res["m"].outputSum == gauss
             and res["m"].totalMatches is None, f"build-only: {res['m']}")
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
               lambda: sct.scatter_tiles_ref(*args, **kw), errs, times, card)
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
               reps=5, keep=False)
    del args, sorted_flat, plan
    torch.cuda.empty_cache()
    return total


def _cli_line(argv, dev) -> dict:
    """Run the CLI in-process on ``dev``; return its JSON line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _require(cli.main(argv, device=dev) == 0, f"cli {argv} failed")
    print(f"cli: {' '.join(argv)}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


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
        torch.cuda.empty_cache()
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
    usage = "; ".join(line.split(":", 1)[1].strip()
                      for line in report.splitlines() if "Used" in line)
    print(f"build: nvcc {seconds:.2f} s -> {path.name}; {usage}")

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
    max_err = 0
    for name, rkeys, skeys, method, passes in cases:
        err, viols, flagged = _check_kernel(name, rkeys, skeys, method,
                                            passes)
        max_err = max(max_err, err)
        if name.startswith("underestimated"):
            _require(viols > 0, "the underestimated window left no inversions")
        if name.startswith("6000"):
            _require(flagged > 0, "the 6000-copy run did not flag its tile")
    del cases, dup, dup_r, heavy_s
    _check_other_kernels(dev, errs)

    # 4. the main path at 2^27, counting K1 launches
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
          f"{out} (first call {first_s:.3f} s), K1 launches={launches}")
    _require(out.matches == n, f"expected {n} matches, got {out.matches}")
    _require(out.output_sum == out.input_sum == expect_sum,
             "conservation violated")
    _require(out.violations == 0 and out.overflow_tiles == 0,
             "violations or flagged tiles on the main path")
    _require(launches >= 1, "the main path did not launch K1")

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

    # 5. times
    r_flat = bb.to_tiles(rkeys, TILE)
    _, _, row_off, rows_needed = bb.band_rows(r_flat, skeys, TILE)
    args = (r_flat, s2d, row_off, rows_needed)
    kw = dict(tile=TILE, method="blocks", passes=WINDOW)
    got = fsc.fused_sort_count(*args, **kw)
    want = fsc.fused_sort_count_ref(*args, **kw)
    err = _max_abs_err(got, want)
    print(f"times: K1 at 2^{LOG2_N} against its plain version: "
          f"max_abs_err={err}")
    _require(not err, "K1 differs from its plain version at 2^27")
    max_err = max(max_err, err)
    del got, want
    k1_ms = _events_ms(lambda: fsc.fused_sort_count(*args, **kw), 20)
    plain_ms = _events_ms(lambda: fsc.fused_sort_count_ref(*args, **kw),
                          3)
    join_ms = _events_ms(lambda: bb.enqueue_banded_join(
        rkeys, skeys, tile=TILE, locality_window=WINDOW, unique_both=True,
        s2d=s2d), 10)
    print(f"times: K1 {k1_ms:.4f} ms, plain {plain_ms:.4f} ms, whole device "
          f"chain {join_ms:.4f} ms (glue {join_ms - k1_ms:.4f} ms) at "
          f"2^{LOG2_N}, tile {TILE} [{card}]")
    del args, r_flat, row_off, rows_needed, rkeys, skeys, s2d
    torch.cuda.empty_cache()
    rec = bench.measure(log2_n=LOG2_N, window=WINDOW, reps=3, pipe=5)
    print(f"times: bench {json.dumps(rec)} "
          f"sustained={2 * n / rec['seconds'] / 1e6:.1f} Mtuples/s "
          f"single={2 * n / rec['single_run_seconds'] / 1e6:.1f} Mtuples/s "
          f"[{card}; {_smi('clocks.sm,power.draw,temperature.gpu')}]")

    errs["fused_sort_count"] = max_err
    times = {"fused_sort_count": (k1_ms, plain_ms)}

    # 6-7. every other path at 2^27, then K2-K5 at their paths' shapes
    counts = _paths(dev, card, errs, times)
    counts["fused_sort_count"] += main_counts["fused_sort_count"]
    # 8-9. K6 and the multipass radix join, then the CLI's paths
    for more in (_radix(dev, card, errs, times), _cli_paths(dev, card)):
        for k, v in more.items():
            counts[k] += v
    for name in KERNELS:
        _require(counts[name] > 0, f"no path launched {name}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": CSRC + src,
        "replaces": replaces, "launches": counts[name],
        "max_abs_err": errs[name], "ms": times[name][0],
        "plain_ms": times[name][1]}
        for name, (_, src, replaces) in KERNELS.items()]}))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
