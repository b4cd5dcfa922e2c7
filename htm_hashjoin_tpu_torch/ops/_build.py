"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of the package, one process per
source, all started together, and links the objects into one shared library
with a plain C interface, which ``ctypes`` loads.  The build runs at first
use, never at import, into ``htm_hashjoin_tpu_torch/build/`` (listed in
``.gitignore``); the library's name carries a hash of the sources, the
headers they include (``csrc/*.cuh``) and the flags, so an edited source or
header builds anew.  ptxas's report (registers and spills per kernel) is
kept beside the library; ``kernel_usage`` reads it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17")
COMPILE_FLAGS = (*ARCH_FLAGS, "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home)] if home else []
    candidates.append(Path("/usr/local/cuda"))
    for root in candidates:
        if (root / "bin" / "nvcc").is_file():
            return str(root / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted([*_sources(), *SRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhtm_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise on the first that fails.  Returns
    their standard error, concatenated."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [proc.communicate() for proc in procs]
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}"
                               f" on {cmd[-1]}:\n{out}{err}")
    return "".join(err for _, err in outs)


@functools.cache
def build() -> tuple[Path, float, str]:
    """Compile the sources if their library is missing.  Returns (library
    path, seconds spent compiling and linking (0 when it was already
    built), nvcc's report: registers, spills and shared memory per kernel,
    kept beside the library)."""
    out = library_path()
    report_path = out.with_suffix(".ptxas")
    if out.exists():
        return out, 0.0, (report_path.read_text() if report_path.exists()
                          else "")
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    t0 = time.perf_counter()
    try:
        report = _run_all([[nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj),
                            str(src)] for src, obj in zip(_sources(), objs)])
        tmp = out.with_name(f"{tag}.tmp")
        _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    report_path.write_text(report)
    os.replace(tmp, out)   # atomic: a concurrent build never loads half a file
    return out, time.perf_counter() - t0, report


@functools.cache
def load_library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()[0]))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {
        "htm_fused_sort_count": [p, p, i64, p, p, p, p, p, p, p, p, i, i, i,
                                 i, p],
        "htm_tile_minmax": [p, p, p, i, i, p],
        "htm_sort_tiles": [p, p, p, i, i, i, i, p],
        "htm_radix_sort_keys": [p, p, p, p, i64, i64, p],
        "htm_banded_count": [p, p, i64, p, p, p, i, p, p, i, p],
        "htm_banded_count_narrow": [p, p, i64, p, p, p, p, p, i, i, p],
        "htm_scatter_tiles": [p, p, p, p, i64, i, i, i, p],
        "htm_sort_kv_tiles": [p, p, p, p, i, i, i, p],
        "htm_radix_sort_pairs": [p, p, p, p, p, p, p, i64, i64, p],
        "htm_claim_insert": [p, p, i, i64, i64, i, i, p, p, i64, p, i64, p,
                             p, p],
        "htm_hash_probe": [p, p, i, i64, i64, i, i, p, p, p],
        "htm_rot_pack": [p, p, i64, i64, i, i, i, i, i, i64, i64, p, p, p],
        "htm_rot_unpack": [p, i64, i, i, i, i, i, p, p],
        "htm_multijoin_probe": [p, p, p, i64, i, i, i64, i64, p, i, p, p,
                                p, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    lib.htm_radix_sort_scratch_words.argtypes = [i64]
    lib.htm_radix_sort_scratch_words.restype = i64
    lib.htm_claim_insert_scratch_words.argtypes = [i64, i64, i]
    lib.htm_claim_insert_scratch_words.restype = i64
    lib.htm_cuda_error_string.argtypes = [i]
    lib.htm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = load_library().htm_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def _readable(mangled: str) -> str:
    """``name<args>`` of a kernel in a source's unnamed namespace, from its
    mangled name (integer template arguments only); else the name as
    given."""
    ns = re.match(r"_ZN(\d+)_GLOBAL__N_", mangled)
    if not ns:
        return mangled
    rest = mangled[ns.end(1) + int(ns.group(1)):]
    size = re.match(r"\d+", rest)
    if not size:
        return mangled
    end = size.end() + int(size.group())
    name, rest = rest[size.end():end], rest[end:]
    args = (re.findall(r"L[a-z](-?\d+)E", rest[:rest.find("EE") + 1])
            if rest.startswith("I") else [])
    return name + (f"<{','.join(args)}>" if args else "")


def kernel_usage(report: str) -> dict[str, tuple[int, int, int]]:
    """Each entry function of nvcc's ``-Xptxas -v`` report -> (registers a
    thread, spill store bytes, spill load bytes)."""
    regs, spills, entry, props = {}, {}, None, None
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = m.group(1)
        elif m := re.search(r"Function properties for (\S+)", line):
            props = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spills[props] = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            regs[entry] = int(m.group(1))
    return {_readable(name): (n, *spills.get(name, (0, 0)))
            for name, n in regs.items()}
