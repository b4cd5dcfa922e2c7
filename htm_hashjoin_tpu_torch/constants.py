"""Layout constants shared with the JAX package's banded join kernels.

Copied rather than imported: importing ``htm_hashjoin_tpu`` pulls in jax
(``htm_hashjoin_tpu/ops/pallas/join_kernels.py`` defines the originals).
"""

LANES = 128               # keys per band row: row_off / rows_needed count rows
MAXI32 = (1 << 31) - 1    # padding sentinel of every tiled key array
INT32_MIN = -(1 << 31)    # a fully padded tile's max (padding excluded)
PACK_LIMIT = 1 << 29      # keys at or above this never match (count as padding)
OV_ROWS = 8               # overhang rows read past a tile's first S window
