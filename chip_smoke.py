#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (htm_hashjoin_tpu_torch) on one GPU.

Phases, one line each:
  1. device   - the card's name and power limit (nvidia-smi);
  2. build    - nvcc builds the kernel from htm_hashjoin_tpu_torch/csrc/;
  3. kernel   - K1 (fused_sort_count) against its plain torch version on
                the card, on cases of a few tiles, exactly (integer outputs;
                counts only on tiles with zero inversions);
  4. main     - the headline join, 2^27 locality build + 2^27 sorted probe,
                through banded_join_pipelined with bench.py's asserts and a
                count of K1 launches; then the abort -> bitonic retry at 2^24;
  5. times    - sustained (5 joins per readback) and single-run throughput,
                and K1 against its plain version at 2^27 (held equal there too).
Then a JSON line of kernels and, last, {"ok": true, "device": {...}}.
Any failure raises: the script exits non-zero and prints no result.  With no
CUDA device it exits 1 at once.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from htm_hashjoin_tpu_torch import bench
from htm_hashjoin_tpu_torch.data.generators import (local_shuffled_keys,
                                                    sorted_keys)
from htm_hashjoin_tpu_torch.joins import banded_backend as bb
from htm_hashjoin_tpu_torch.ops import _build
from htm_hashjoin_tpu_torch.ops import fused_sort_count as fsc

TILE = 8192
LOG2_N = 27
WINDOW = 16
KERNEL_SOURCE = "htm_hashjoin_tpu_torch/csrc/fused_sort_count.cu"
TPU_KERNEL = "htm_hashjoin_tpu/ops/pallas/join_kernels.py:1068"


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

    # 4. the main path at 2^27, counting K1 launches
    n = 1 << LOG2_N
    expect_sum = n * (n + 1) // 2
    rkeys = local_shuffled_keys(n, WINDOW, 0, dev)
    skeys = sorted_keys(n, dev)
    s2d = bb.prepare_probe_side(skeys, TILE)
    torch.cuda.synchronize()
    fsc.LAUNCHES = 0
    t0 = time.perf_counter()
    out = bb.banded_join_pipelined(rkeys, skeys, tile=TILE,
                                   locality_window=WINDOW, unique_both=True,
                                   s2d=s2d)
    first_s = time.perf_counter() - t0
    launches = fsc.LAUNCHES
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

    print(json.dumps({"kernels": [{
        "name": "fused_sort_count", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches, "max_abs_err": max_err,
        "ms": k1_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
