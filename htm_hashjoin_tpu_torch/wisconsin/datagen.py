"""Canonical .tbl dataset writers — the reference's datagen scripts.

Reference: mc/wisconsin-src/datagen/{genbuild.py,genprobe.py,generate.sh} —
python2 scripts that print the canonical Wisconsin workload:

- build side (016M_build.tbl): rows ``i|i`` for i in 1..16M (key == rid);
- probe side (256M_probe.tbl): 16 independently shuffled copies of the build
  key set, rid running 1..256M — so every build key matches exactly 16 probe
  rows and the join output cardinality equals the probe size.

Here the rows are produced as numpy arrays and written through the native
parallel .tbl writer (native/tblio.cpp) when available, with a numpy
fallback; sizes are parameterized so tests can use small instances.
"""

from __future__ import annotations

import os

import numpy as np

from ..data import tblio

DEFAULT_MAXKEY = 16 * 1024 * 1024
DEFAULT_COPIES = 16


def build_rows(max_key: int = DEFAULT_MAXKEY) -> np.ndarray:
    """(max_key, 2) int64 array: row i is ``(i, i)`` — genbuild.py semantics."""
    col = np.arange(1, max_key + 1, dtype=np.int64)
    return np.stack([col, col], axis=1)


def probe_rows(max_key: int = DEFAULT_MAXKEY, copies: int = DEFAULT_COPIES,
               seed: int = 0) -> np.ndarray:
    """(copies * max_key, 2) int64 array: ``copies`` independently shuffled
    permutations of 1..max_key as join keys, rids 1..copies*max_key —
    genprobe.py semantics (its shuffles use python's global RNG; the seeded
    numpy Generator here keeps the same distributional contract while being
    reproducible)."""
    rng = np.random.default_rng(seed)
    keys = np.concatenate([rng.permutation(max_key) + 1
                           for _ in range(copies)]).astype(np.int64)
    rids = np.arange(1, copies * max_key + 1, dtype=np.int64)
    return np.stack([rids, keys], axis=1)


def _write(path: str, rows: np.ndarray) -> None:
    if not tblio.write_tbl(path, rows):
        with open(path, "w") as f:
            for r in rows:
                f.write("|".join(str(int(x)) for x in r) + "\n")


def generate(out_dir: str = ".", max_key: int = DEFAULT_MAXKEY,
             copies: int = DEFAULT_COPIES, seed: int = 0) -> None:
    """generate.sh: write both canonical .tbl files into ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    mm = max_key // (1024 * 1024)
    _write(os.path.join(out_dir, f"{mm:03d}M_build.tbl"), build_rows(max_key))
    _write(os.path.join(out_dir, f"{mm * copies:03d}M_probe.tbl"),
           probe_rows(max_key, copies, seed))


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("outDir", nargs="?", default=".")
    p.add_argument("--maxKey", type=int, default=DEFAULT_MAXKEY)
    p.add_argument("--copies", type=int, default=DEFAULT_COPIES)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    generate(a.outDir, a.maxKey, a.copies, a.seed)
    print(f"wrote build+probe .tbl files under {a.outDir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
