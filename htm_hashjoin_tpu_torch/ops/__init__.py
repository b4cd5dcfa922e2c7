"""Kernels of the port: one module per kernel, each with its plain torch
version beside the CUDA launch (K1 ``fused_sort_count``, K2 ``sort_tiles``,
K3 ``global_sort``, K4 ``banded_count``, K5 ``banded_count_narrow``, K6
``scatter_tiles``, K7a ``sort_kv_tiles``, K7 ``global_sort_kv``; K3 and K7
launch the radix sort of ``radix_sort``), the tile sorters' plain forms
(``sorters``), the multipass radix partition around K2 and K6
(``radix_kernels``), K1's band prepass (``tile_minmax``), the sort route's
MSB partition and tagged probe (``partition``, ``probe``), the hash
functions, scatter builds and table probes of the hash joins
(``hashing``, ``insert``, ``probe``), the Wisconsin split's packing
around K7 (``rot_pack``, ``rot_unpack``) and sortmerge's count (``sortops``),
the wrappers' shared checks (``_args``) and the nvcc build (``_build``)."""
