"""End to end: the 95th percentile of all join intervals of the window
(the nearest rank: the smallest interval that at least 95 % of the joins
do not exceed), in milliseconds."""

import math

UNIT = "ms"


def read(run):
    times = sorted(j.seconds for j in run.joins)
    return times[math.ceil(0.95 * len(times)) - 1] * 1e3
