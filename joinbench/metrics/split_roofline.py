"""Partitioner: the multijoin's partition split as a share of its
roofline.  The bytes any split of |R| + |S| rows of an int32 key and an
int32 payload needs at least, each row read once and written once in
partition order (16 bytes a row), at the card's published 3.35 TB/s, over
the device-busy seconds (the union of device operations) inside the
port's ``hj.split`` spans of the traced joins
(``hash_build_roofline.busy_in``), in percent.  The bytes are fixed by the
cell, not by the implementation.  A program without the span reads
nothing."""

from joinbench import cells

UNIT = "%"
LAYER = "partitioner"
MOVES = "join_mtuples_per_s"
SPAN = "hj.split"


def split_bytes(r_size: int, s_size: int) -> int:
    return 16 * (r_size + s_size)


def read(run):
    settings = run.cell.settings
    return cells.metric_module("hash_build_roofline").share(
        run, SPAN, split_bytes(settings["r_size"], settings["s_size"]))
