"""The port's hand-written kernels, by name: every ``__global__`` function
of ``htm_hashjoin_tpu_torch/csrc/*.cu``, read from the sources, so a kernel
a later change adds is known without an edit here."""

from __future__ import annotations

import functools
import importlib.util
import re
from pathlib import Path

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?([A-Za-z_]\w*)\s*\(")


def csrc_dir() -> Path:
    spec = importlib.util.find_spec("htm_hashjoin_tpu_torch")
    if spec is None or spec.origin is None:
        raise RuntimeError("htm_hashjoin_tpu_torch is not importable")
    return Path(spec.origin).parent / "csrc"


@functools.cache
def csrc_kernels(directory: Path | None = None) -> dict:
    """``{kernel function name: source file name}``."""
    out = {}
    for src in sorted((directory or csrc_dir()).glob("*.cu")):
        for m in _GLOBAL.finditer(src.read_text()):
            out[m.group(1)] = src.name
    return out
