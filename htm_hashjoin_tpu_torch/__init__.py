"""htm_hashjoin_tpu_torch — the banded join engine in PyTorch and CUDA.

A port of ``htm_hashjoin_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100, slice by slice; the JAX package stays the reference every
piece is tested against.  This slice covers the headline build+probe join:
a locality-shuffled build side probed by a sorted probe side, through one
hand-written CUDA kernel (``csrc/fused_sort_count.cu``) on CUDA tensors and
its plain torch version on CPU tensors.

Importing the package imports torch only: no jax, no kernel build (the
kernel is compiled by nvcc at its first launch).
"""

from .version import __version__
from .data import generators
from .joins import (BandedJoinOutcome, banded_join_pipelined,
                    enqueue_banded_join, prepare_probe_side)

__all__ = ["__version__", "generators", "BandedJoinOutcome",
           "banded_join_pipelined", "enqueue_banded_join",
           "prepare_probe_side"]
