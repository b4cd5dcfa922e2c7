"""Kernels of the port: one module per kernel, each with its plain torch
version beside the CUDA launch (``fused_sort_count``), the tile sorters'
plain forms (``sorters``) and the nvcc build (``_build``)."""
