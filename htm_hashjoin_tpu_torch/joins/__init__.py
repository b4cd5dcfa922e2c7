from .banded_backend import (BandedJoinOutcome, banded_join_pipelined,
                             enqueue_banded_join, prepare_probe_side)

__all__ = ["BandedJoinOutcome", "banded_join_pipelined",
           "enqueue_banded_join", "prepare_probe_side"]
