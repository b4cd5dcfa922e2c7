"""htm_hashjoin_tpu_torch — the banded join engine in PyTorch and CUDA.

A port of ``htm_hashjoin_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100, slice by slice; the JAX package stays the reference every
piece is tested against.  It covers the banded engine (the build-only
pipeline and every build+probe plan, with its abort -> retry, repair and
replan paths), the planner and its HTM_ADAPT dial, the htm, radix and
adaptive joins (HTM_SWITCH), the multipass radix partition, the
generators and the CLI (``python -m htm_hashjoin_tpu_torch.cli``), through
six hand-written CUDA kernels (``csrc/*.cu``: K1 fused sort + count, K2
tile sort, K3 global sort, K4 general count, K5 narrow count, K6 radix
scatter) on CUDA tensors and their plain torch versions on CPU tensors.

Importing the package imports torch only: no jax, no kernel build (the
kernels are compiled by nvcc at their first launch).
"""

from .version import __version__
from .data import generators
from .joins import (BandedBuild, BandedJoinOutcome, banded_build_pipelined,
                    banded_join_pipelined, banded_probe, enqueue_banded_join,
                    enqueue_full_join, prepare_probe_side)

__all__ = ["__version__", "generators", "BandedBuild", "BandedJoinOutcome",
           "banded_build_pipelined", "banded_join_pipelined", "banded_probe",
           "enqueue_banded_join", "enqueue_full_join", "prepare_probe_side"]
