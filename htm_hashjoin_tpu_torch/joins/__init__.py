"""Joins of the port: the banded engine, and the algorithms the CLI
dispatches to (``DISPATCH``).  htm, radix and adaptive are ported; the
other five names raise ``NotImplementedError`` until their module is."""

from .banded_backend import (BandedBuild, BandedJoinOutcome,
                             banded_build_from_sorted, banded_build_pipelined,
                             banded_join_pipelined, banded_probe,
                             enqueue_banded_build, enqueue_banded_join,
                             enqueue_full_join, prepare_probe_side,
                             sort_probe_side, tagged_count)
from .htm import htm_join
from .radix import radix_join
from .adaptive import adaptive_join


def _not_ported(algo: str):
    def join(r, s=None, cfg=None):
        raise NotImplementedError(
            f"--algo {algo} is not ported yet: ROADMAP queue 1 item 7 "
            f"(joins/{'npo' if algo.startswith('npo') else algo}.py and "
            f"ops/insert.py)")
    join.__name__ = f"{algo}_join"
    return join


DISPATCH = {
    "nocc": _not_ported("nocc"),
    "atomic": _not_ported("atomic"),
    "htm": htm_join,
    "radix": radix_join,
    "sortmerge": _not_ported("sortmerge"),
    "npo": _not_ported("npo"),
    "npo_st": _not_ported("npo_st"),
    "adaptive": adaptive_join,
}

__all__ = ["BandedBuild", "BandedJoinOutcome", "banded_build_from_sorted",
           "banded_build_pipelined", "banded_join_pipelined", "banded_probe",
           "enqueue_banded_build", "enqueue_banded_join", "enqueue_full_join",
           "prepare_probe_side", "sort_probe_side", "tagged_count",
           "htm_join", "radix_join", "adaptive_join", "DISPATCH"]
