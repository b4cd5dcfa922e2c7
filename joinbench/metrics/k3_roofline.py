"""Kernels: K3's share of its roofline, the LSD radix sort of int32 keys
(``csrc/radix_sort.cu``: ``radix_histogram``, ``radix_scatter<false>``):
8 bytes for each key the join needs sorted (read once, written once) at the
card's published 3.35 TB/s, over the device time of those kernels, in
percent.  The join needs R sorted, and S where it is not handed sorted."""

from joinbench import kernels_metric, peaks

UNIT = "%"
LAYER = "kernels"
MOVES = "join_mtuples_per_s"
SOURCE = "radix_sort.cu"
COUNTED = {"radix_histogram", "radix_scatter"}


def keys_sorted(r_size: int, s_size: int, s_sorted: bool) -> int:
    return r_size + (0 if s_sorted else s_size)


def _keys_only(name: str) -> bool:
    # radix_scatter<true> is K7's key-value instance
    return "<true>" not in name


def read(run):
    seconds = kernels_metric.seconds(run, SOURCE, COUNTED, "k3_roofline",
                                     _keys_only)
    if not seconds:
        return None
    settings = run.cell.settings
    need = 8 * keys_sorted(settings["r_size"], settings["s_size"],
                           settings["s_gen"].SORTED)
    return 100.0 * need * len(run.traced) / peaks.HBM_BYTES_PER_S / seconds
