"""Kernels: K7's share of its roofline, the key-value LSD radix sort of
the multijoin's partition split (``csrc/radix_sort.cu``:
``radix_histogram`` and ``radix_scatter<true>``).  The split's bytes
(``split_roofline.split_bytes``: each row's int32 key and int32 payload
read once and written once, 16 bytes a row) at the card's published
3.35 TB/s, over the device time of those kernels inside the port's
``hj.split`` spans of the traced joins (each launch clipped to the spans),
in percent.  K3's instance, ``radix_scatter<false>``, is not counted.  A
program without the span, or whose split launches no K7, reads
nothing."""

from joinbench import cells, peaks, trace

UNIT = "%"
LAYER = "kernels"
MOVES = "join_mtuples_per_s"
SPAN = "hj.split"


def is_k7(name: str) -> bool:
    base = trace.base_name(name)
    return base == "radix_histogram" or (base == "radix_scatter"
                                         and "<true>" in name)


def seconds(run) -> float:
    """Device seconds of K7's launches inside ``hj.split`` over the traced
    joins; 0 without a trace."""
    total = 0.0
    for j in run.traced or ():
        spans = [(lo, hi) for name, lo, hi in j.host if name == SPAN]
        for name, a, b in j.ops:
            if is_k7(name):
                total += sum(max(0.0, min(b, hi) - max(a, lo))
                             for lo, hi in spans)
    return total


def read(run):
    sec = seconds(run)
    if not sec:
        return None
    settings = run.cell.settings
    need = cells.metric_module("split_roofline").split_bytes(
        settings["r_size"], settings["s_size"])
    return 100.0 * need * len(run.traced) / peaks.HBM_BYTES_PER_S / sec
