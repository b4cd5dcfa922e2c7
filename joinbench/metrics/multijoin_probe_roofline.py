"""Joiner: the multijoin's probe as a share of its roofline.  The bytes a
probe that materialises its output needs at least: each S key read once
(4 |S|), each build row's int32 key and payload read once (8 |R|), and
the output's two int32 columns written once (8 per output row, the line's
``outputRows``), at the card's published 3.35 TB/s, over the device-busy
seconds inside the port's ``hj.probe`` spans of the traced joins
(``hash_build_roofline.busy_in``), in percent.  The bytes are fixed by the
cell and the join's answer, not by the implementation.  A program without
the span or the line's count reads nothing."""

from joinbench import cells, peaks

UNIT = "%"
LAYER = "joiner"
MOVES = "join_mtuples_per_s"
SPAN = "hj.probe"


def probe_bytes(r_size: int, s_size: int, output_rows: int) -> int:
    return 4 * s_size + 8 * r_size + 8 * output_rows


def read(run):
    if not run.traced:
        return None
    # the traced joins are the window's second to (TRACED + 1)th
    lines = [j.line for j in run.joins[1:1 + len(run.traced)]]
    if not lines or any(line is None or "outputRows" not in line
                        for line in lines):
        return None
    seconds = cells.metric_module("hash_build_roofline").busy_in(run, SPAN)
    if not seconds:
        return None
    settings = run.cell.settings
    need = sum(probe_bytes(settings["r_size"], settings["s_size"],
                           line["outputRows"]) for line in lines)
    return 100.0 * need / peaks.HBM_BYTES_PER_S / seconds
