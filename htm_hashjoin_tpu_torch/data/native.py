"""ctypes binding for the native C++ generator (native/datagen.cpp).

Counterpart of ``htm_hashjoin_tpu/data/native.py`` (the port keeps its own
copy: the package imports nothing of the JAX one).  The native library is
the host-side generation path (the reference's generator.c counterpart,
``make -C native``); the torch generators in generators.py make relations
on the device.  Every function returns a numpy int32 array; the caller
moves it to a device.
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
                 "libhtmdatagen.so"),
    os.path.join(os.path.dirname(__file__), "libhtmdatagen.so"),
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
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.htm_gen_sorted.argtypes = [i32p, ctypes.c_int64]
        lib.htm_gen_shuffled.argtypes = [i32p, ctypes.c_int64, ctypes.c_uint64]
        lib.htm_gen_local_shuffle.argtypes = [i32p, ctypes.c_int64,
                                              ctypes.c_int64, ctypes.c_uint64]
        lib.htm_gen_uniform.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                        ctypes.c_int64, ctypes.c_uint64]
        lib.htm_gen_fk_from_pk.argtypes = [i32p, ctypes.c_int64,
                                           ctypes.c_int64, ctypes.c_uint64]
        lib.htm_gen_zipf.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                     ctypes.c_double, ctypes.c_uint64]
        lib.htm_gen_nonunique.argtypes = [i32p, ctypes.c_int64,
                                          ctypes.c_int32, ctypes.c_uint64]
        for fn in (lib.htm_gen_sorted, lib.htm_gen_shuffled,
                   lib.htm_gen_local_shuffle, lib.htm_gen_uniform,
                   lib.htm_gen_fk_from_pk, lib.htm_gen_zipf,
                   lib.htm_gen_nonunique):
            fn.restype = None
        lib.htm_checksum.argtypes = [i32p, ctypes.c_int64]
        lib.htm_checksum.restype = ctypes.c_int64
        _LIB = lib
        break
    return _LIB


def available() -> bool:
    return _load() is not None


def _alloc(n: int) -> tuple[np.ndarray, "ctypes.pointer"]:
    arr = np.empty(n, dtype=np.int32)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def sorted_keys(n: int) -> np.ndarray:
    lib = _load()
    arr, p = _alloc(n)
    lib.htm_gen_sorted(p, n)
    return arr


def shuffled_keys(n: int, seed: int = 0) -> np.ndarray:
    lib = _load()
    arr, p = _alloc(n)
    lib.htm_gen_shuffled(p, n, seed)
    return arr


def local_shuffled_keys(n: int, window: int, seed: int = 0) -> np.ndarray:
    lib = _load()
    arr, p = _alloc(n)
    lib.htm_gen_local_shuffle(p, n, window, seed)
    return arr


def uniform_keys(n: int, distinct: int, window: int = 16,
                 seed: int = 0) -> np.ndarray:
    lib = _load()
    arr, p = _alloc(n)
    lib.htm_gen_uniform(p, n, distinct, window, seed)
    return arr


def fk_from_pk_keys(s_size: int, r_size: int, seed: int = 0) -> np.ndarray:
    lib = _load()
    arr, p = _alloc(s_size)
    lib.htm_gen_fk_from_pk(p, s_size, r_size, seed)
    return arr


def zipf_keys(n: int, alphabet: int, theta: float, seed: int = 0) -> np.ndarray:
    lib = _load()
    arr, p = _alloc(n)
    lib.htm_gen_zipf(p, n, alphabet, theta, seed)
    return arr


def nonunique_keys(n: int, max_key: int, seed: int = 0) -> np.ndarray:
    lib = _load()
    arr, p = _alloc(n)
    lib.htm_gen_nonunique(p, n, max_key, seed)
    return arr


def checksum(keys: np.ndarray) -> int:
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    return int(lib.htm_checksum(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), keys.shape[0]))
