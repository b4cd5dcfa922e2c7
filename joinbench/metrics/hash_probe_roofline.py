"""Hash table: the scatter build's probe, as a share of its roofline.
The bytes a probe of |S| int32 keys needs at least, each key read once
and its home slot read once (8 |S|), at the card's published 3.35 TB/s,
over the device-busy seconds inside the port's ``hj.probe`` spans of the
traced joins (``hash_build_roofline.share``), in percent.  A program
without the span reads nothing."""

from joinbench import cells

UNIT = "%"
LAYER = "hash table"
MOVES = "join_mtuples_per_s"
SPAN = "hj.probe"


def probe_bytes(s_size: int) -> int:
    return 8 * s_size


def read(run):
    return cells.metric_module("hash_build_roofline").share(
        run, SPAN, probe_bytes(run.cell.settings["s_size"]))
