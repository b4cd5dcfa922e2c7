"""Partitioner: the multipass radix join's partition as a share of its
roofline.  The bytes any partition of |R| int32 keys in ``radixPasses``
passes needs at least, each key read once and written once a pass
(8 x passes x |R|), at the card's published 3.35 TB/s, over the
device-busy seconds (the union of device operations) inside the port's
``hj.partition`` spans of the traced joins
(``hash_build_roofline.busy_in``), in percent.  The bytes are fixed by the
configuration (its size and pass count), not by the implementation.  A
program without the span reads nothing."""

from joinbench import cells

UNIT = "%"
LAYER = "partitioner"
MOVES = "join_mtuples_per_s"
SPAN = "hj.partition"


def partition_bytes(r_size: int, passes: int) -> int:
    return 8 * passes * r_size


def read(run):
    settings = run.cell.settings
    return cells.metric_module("hash_build_roofline").share(
        run, SPAN, partition_bytes(settings["r_size"],
                                   settings["cfg"].radix_passes))
