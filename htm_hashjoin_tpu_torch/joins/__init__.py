from .banded_backend import (BandedBuild, BandedJoinOutcome,
                             banded_build_from_sorted, banded_build_pipelined,
                             banded_join_pipelined, banded_probe,
                             enqueue_banded_build, enqueue_banded_join,
                             enqueue_full_join, prepare_probe_side,
                             sort_probe_side, tagged_count)

__all__ = ["BandedBuild", "BandedJoinOutcome", "banded_build_from_sorted",
           "banded_build_pipelined", "banded_join_pipelined", "banded_probe",
           "enqueue_banded_build", "enqueue_banded_join", "enqueue_full_join",
           "prepare_probe_side", "sort_probe_side", "tagged_count"]
