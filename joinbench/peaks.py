"""Published peaks of the card the cells run on.

One NVIDIA H100 SXM (NVIDIA's data sheet): 80 GB of HBM3 at 3.35 TB/s,
at its full power limit of 700 W; a run prints the card's own limit.
"""

HBM_BYTES_PER_S = 3.35e12
