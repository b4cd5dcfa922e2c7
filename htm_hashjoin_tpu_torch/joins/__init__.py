"""Joins of the port: the banded engine, and the eight algorithms the CLI
dispatches to (``DISPATCH``)."""

from .banded_backend import (BandedBuild, BandedJoinOutcome,
                             banded_build_from_sorted, banded_build_pipelined,
                             banded_join_pipelined, banded_probe,
                             enqueue_banded_build, enqueue_banded_join,
                             enqueue_full_join, prepare_probe_side,
                             sort_probe_side, tagged_count)
from .nocc import nocc_join
from .atomic import atomic_join
from .htm import htm_join
from .radix import radix_join
from .sortmerge import sortmerge_join
from .npo import npo_join, npo_st_join
from .adaptive import adaptive_join

DISPATCH = {
    "nocc": nocc_join,
    "atomic": atomic_join,
    "htm": htm_join,
    "radix": radix_join,
    "sortmerge": sortmerge_join,
    "npo": npo_join,
    "npo_st": npo_st_join,
    "adaptive": adaptive_join,
}

__all__ = ["BandedBuild", "BandedJoinOutcome", "banded_build_from_sorted",
           "banded_build_pipelined", "banded_join_pipelined", "banded_probe",
           "enqueue_banded_build", "enqueue_banded_join", "enqueue_full_join",
           "prepare_probe_side", "sort_probe_side", "tagged_count",
           "nocc_join", "atomic_join", "htm_join", "radix_join",
           "sortmerge_join", "npo_join", "npo_st_join", "adaptive_join",
           "DISPATCH"]
