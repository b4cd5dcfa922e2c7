"""Kernels of the port: one module per kernel, each with its plain torch
version beside the CUDA launch (K1 ``fused_sort_count``, K2 ``sort_tiles``,
K3 ``global_sort``, K4 ``banded_count``, K5 ``banded_count_narrow``, K6
``scatter_tiles``), the tile sorters' plain forms (``sorters``), the
multipass radix partition around K2 and K6 (``radix_kernels``), the sort
route's MSB partition and tagged probe (``partition``, ``probe``), the
wrappers' shared checks (``_args``) and the nvcc build (``_build``)."""
