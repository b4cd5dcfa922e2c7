"""End to end: set-up, from the start of ``run.py`` to the first timed
join: imports, the CUDA context, the kernel library (built on a
checkout's first run), the generators' tables and one untimed join."""

UNIT = "s"


def read(run):
    return run.setup_s
