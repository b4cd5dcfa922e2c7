"""ctypes binding for the native .tbl parser/writer (native/tblio.cpp) —
the Wisconsin loader.cpp counterpart.

Integer-schema files load through the parallel native parser; anything else
(string columns, missing library) falls back to the Python path in the
caller.  Build with ``make -C native``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "libhtmtblio.so"),
    os.path.join(os.path.dirname(__file__), "libhtmtblio.so"),
]


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    for p in _LIB_PATHS:
        try:
            lib = ctypes.CDLL(os.path.abspath(p))
        except OSError:
            continue
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.htm_tbl_count_rows.argtypes = [ctypes.c_char_p]
        lib.htm_tbl_count_rows.restype = ctypes.c_int64
        lib.htm_tbl_load.argtypes = [ctypes.c_char_p, i64p, ctypes.c_int32,
                                     ctypes.c_int64, ctypes.c_char]
        lib.htm_tbl_load.restype = ctypes.c_int64
        lib.htm_tbl_write.argtypes = [ctypes.c_char_p, i64p, ctypes.c_int32,
                                      ctypes.c_int64, ctypes.c_char]
        lib.htm_tbl_write.restype = ctypes.c_int64
        _LIB = lib
        break
    return _LIB


def available() -> bool:
    return _load() is not None


def load_tbl(path: str, ncols: int, sep: str = "|") -> Optional[np.ndarray]:
    """Parse an integer .tbl into an (rows, ncols) int64 array; None if the
    native library is unavailable or the file cannot be read."""
    lib = _load()
    if lib is None:
        return None
    rows = lib.htm_tbl_count_rows(path.encode())
    if rows < 0:
        return None
    out = np.empty((rows, ncols), dtype=np.int64)
    got = lib.htm_tbl_load(path.encode(),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                           ncols, rows, sep.encode()[:1])
    if got != rows:
        return None
    return out


def write_tbl(path: str, data: np.ndarray, sep: str = "|") -> bool:
    """Write an (rows, ncols) integer array as a sep-separated .tbl."""
    lib = _load()
    if lib is None:
        return False
    data = np.ascontiguousarray(data, dtype=np.int64)
    rows = lib.htm_tbl_write(path.encode(),
                             data.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                             data.shape[1], data.shape[0], sep.encode()[:1])
    return rows == data.shape[0]
