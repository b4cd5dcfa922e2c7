"""Hash table: the scatter build's share of its roofline.  The bytes any
open-addressing build of |R| int32 keys into T slots needs at least, each
key read once (4 |R|) and each slot of the table written once (4 T, T =
next_pow2(scaleOutput x |R|), AtomicHashBuild.hpp:21-25), at the card's
published 3.35 TB/s, over the device-busy seconds (the union of device
operations) inside the port's ``hj.build`` spans of the traced joins, in
percent.  The bytes are fixed by the cell, not by the implementation, so
any build of the same table is read against the same work.  A program
without the span reads nothing."""

from joinbench import peaks, trace

UNIT = "%"
LAYER = "hash table"
MOVES = "join_mtuples_per_s"
SPAN = "hj.build"


def table_slots(r_size: int, scale_output: int) -> int:
    """T = next_pow2(max(2, scale_output x r_size))."""
    return 1 << (max(2, scale_output * r_size) - 1).bit_length()


def build_bytes(r_size: int, scale_output: int) -> int:
    return 4 * r_size + 4 * table_slots(r_size, scale_output)


def busy_in(run, name: str) -> float:
    """Device-busy seconds inside the host spans ``name`` over the traced
    joins: for each join, the union of its device operations clipped to
    each such span; 0 without a trace or the span."""
    if not run.traced:
        return 0.0
    total = 0.0
    for j in run.traced:
        for span_name, lo, hi in j.host:
            if span_name != name:
                continue
            total += sum(b - a for a, b in trace.union(
                (max(a, lo), min(b, hi)) for _, a, b in j.ops
                if b > lo and a < hi))
    return total


def share(run, name: str, need_bytes: int):
    """``need_bytes`` a traced join at the card's peak over the busy
    seconds inside the spans ``name``, in percent; None where nothing is
    busy inside them."""
    seconds = busy_in(run, name)
    if not seconds:
        return None
    return (100.0 * need_bytes * len(run.traced) / peaks.HBM_BYTES_PER_S
            / seconds)


def read(run):
    cfg = run.cell.settings["cfg"]
    return share(run, SPAN, build_bytes(cfg.r_size, cfg.scale_output))
