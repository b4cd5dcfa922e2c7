"""Kernels of the port: one module per kernel, each with its plain torch
version beside the CUDA launch (K1 ``fused_sort_count``, K2 ``sort_tiles``,
K3 ``global_sort``, K4 ``banded_count``, K5 ``banded_count_narrow``), the
tile sorters' plain forms (``sorters``), the wrappers' shared checks
(``_args``) and the nvcc build (``_build``)."""
