"""End to end: the highest peak of device memory over the window's joins
(``torch.cuda.max_memory_allocated()``, reset before each join once its
inputs exist, so it holds them), in GiB; the generators' tables, live
through the window, are the benchmark's and left out."""

UNIT = "GiB"


def read(run):
    return max(j.peak_bytes for j in run.joins) / 2**30
