"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of the package into one shared
library with a plain C interface, which ``ctypes`` loads.  The build runs at
first use, never at import, into ``htm_hashjoin_tpu_torch/build/`` (listed
in ``.gitignore``); the library's name carries a hash of the sources and
flags, so an edited source builds anew.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhtm_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def build() -> tuple[Path, float, str]:
    """Compile the sources if their library is missing.  Returns (library
    path, seconds spent compiling, nvcc's report: registers and shared
    memory per kernel, or "" when the library was already built)."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {res.returncode}:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build never loads half a file
    return out, seconds, res.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()[0]))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.htm_fused_sort_count.argtypes = [p, p, i64, p, p, p, p, p, p,
                                         i, i, i, i, p]
    lib.htm_fused_sort_count.restype = i
    lib.htm_cuda_error_string.argtypes = [i]
    lib.htm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = load_library().htm_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
