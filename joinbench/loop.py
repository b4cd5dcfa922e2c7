"""One run of a cell: set-up, the measured window, then the check.

A cell's entry (``entries/<entry>.py``, ``cells``) makes its inputs and
makes the timed call; its reference (``entries/<entry>_reference.py``)
works out the numbers the check holds.  Set-up makes
what the entry keeps for a run and joins one untimed set of inputs of the
cell's own shapes.  The window is a closed loop, one client: make fresh
inputs for join ``i`` from ``(seed, i)``, fence them, reset the
peak-memory counter, then time the entry's ``join`` (for ``join_step``,
the port CLI's join step ``DISPATCH[cfg.algo.value](r, s, cfg)``) up to the
synchronised device after its return.  Joins start until ``seconds`` have
passed.  A traced run profiles the window's first ``TRACED + 1`` joins and
reads the last ``TRACED``: the first carries the profiler's own start-up.

Once the window has closed and the program's tensors are freed, a sample
of the window's joins drawn from the seed is made again from its
``(seed, i)``, and the entry's plain reference works out the numbers each
line is held to, each within the cell's limit (``cell.limits``).
"""

from __future__ import annotations

import dataclasses
import random
import sys
import time
import traceback

import torch

from . import gen, trace

TRACED = 5       # joins a traced run reads: the window's second to sixth
SAMPLE = 32      # joins the check makes again and compares


@dataclasses.dataclass
class Join:
    index: int
    seconds: float          # the join's interval
    generate_s: float       # making and fencing its inputs (not timed)
    peak_bytes: int         # peak device memory in it, its inputs included,
                            # the entry's state (its table_bytes) not
    tuples: int             # the inputs' tuples (|R| + |S|)
    line: dict | None       # the join's line
    error: str | None       # what it raised, if it raised
    fingerprint: tuple      # of its inputs, to see them made again alike


@dataclasses.dataclass
class Run:
    """Everything a metric reader reads (``metrics/*.py``)."""
    cell: object
    seed: int
    setup_s: float
    table_bytes: int        # the entry's state, held through the window
    joins: list
    traced: list | None     # trace.TracedJoin of a traced run
    check: dict             # {name: worst gap over the sample}
    failed: int


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def fingerprint(keys: torch.Tensor) -> tuple:
    """Two numbers that differ, but for a collision, when two key tensors
    differ: the sum, and a position-weighted sum of a strided sample."""
    sample = keys[::1021].to(torch.int64)
    weights = torch.arange(1, sample.numel() + 1, device=keys.device)
    return (int(torch.sum(keys, dtype=torch.int64)),
            int(torch.sum(sample * weights)))


class Inputs:
    """The cell's inputs: join ``index`` of run ``seed`` gets what its
    entry makes from the join's own streams, on ``device``; the entry's
    state for the run is made once, here."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.device = cell, torch.device(device)
        self.state = cell.entry.prepare(cell, seed, self.device)

    @property
    def table_bytes(self) -> int:
        """Device bytes of the entry's state (zipf's table): live at each
        join, but the benchmark's, not the join's."""
        return self.cell.entry.table_bytes(self.state)

    def make(self, index):
        return self.cell.entry.make(self.cell, self.state, index, self.device)

    def pair(self, index):
        """``(r, s)`` of a ``join_step`` cell's join ``index``."""
        inputs = self.make(index)
        return inputs.r, inputs.s


def _join(join, cell, inputs, device):
    """(line, error) of one join; the device is synchronised after it."""
    try:
        line = join(cell, inputs)
        synchronize(device)
        return line, None
    except Exception:   # a join that raises counts as failed; the run goes on
        err = traceback.format_exc()
        print(f"joinbench: a join raised:\n{err}", file=sys.stderr)
        return None, err.strip().splitlines()[-1]


def _gap(line: dict, field: str, want: int) -> int:
    got = line.get(field)
    if not isinstance(got, int) or isinstance(got, bool):
        return abs(want) + 1          # a missing number is never right
    return abs(got - want)


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float,
        join_fn=None) -> Run:
    """Set-up (from ``t0``, the process's start), the window, the check.
    ``join_fn`` replaces the entry's ``join`` and is called as it is,
    ``join_fn(cell, inputs)``: the tests' faults and the control."""
    join = join_fn or cell.entry.join
    cuda = torch.device(device).type == "cuda"
    source = Inputs(cell, seed, device)
    table_bytes = source.table_bytes
    inputs = source.make("warm-up")
    synchronize(device)
    _join(join, cell, inputs, device)
    del inputs
    setup_s = time.perf_counter() - t0

    joins, prof, profiling = [], None, False
    if traced:
        prof = trace.profile()
        prof.start()
        profiling = True
    deadline = time.perf_counter() + seconds
    while not joins or time.perf_counter() < deadline:
        i = len(joins)
        made = time.perf_counter()
        with trace.span(trace.GENERATE_SPAN, profiling):
            inputs = source.make(i)
            prints = inputs.fingerprint()
            synchronize(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        with trace.span(trace.JOIN_SPAN, profiling):
            start = time.perf_counter()
            line, err = _join(join, cell, inputs, device)
            elapsed = time.perf_counter() - start
        peak = (torch.cuda.max_memory_allocated(device) - table_bytes
                if cuda else 0)
        joins.append(Join(i, elapsed, start - made, peak, inputs.tuples,
                          line, err, prints))
        del inputs
        if profiling and len(joins) == TRACED + 1:
            prof.stop()
            profiling = False
    if profiling:
        prof.stop()
    if cuda:
        torch.cuda.empty_cache()

    traced_joins = (trace.reduce(trace.trace_events(prof))[1:] if traced
                    else None)
    check, failed = _check(joins, source, seed)
    return Run(cell=cell, seed=seed, setup_s=setup_s,
               table_bytes=table_bytes, joins=joins,
               traced=traced_joins, check=check, failed=failed)


def _check(joins, source, seed):
    """The worst gap of each number over a sample of the window's joins
    drawn from the seed, and the count of failed joins: those that raised,
    and sampled ones that disagree or whose inputs were not made again
    alike."""
    cell = source.cell
    limits = cell.limits
    failed = sum(j.error is not None for j in joins)
    gaps = dict.fromkeys(limits, 0)
    pick = random.Random(gen.stream_seed(seed, "check"))
    for j in sorted(pick.sample(joins, min(SAMPLE, len(joins))),
                    key=lambda j: j.index):
        if j.error is not None:
            continue
        inputs = source.make(j.index)
        if inputs.fingerprint() != j.fingerprint:
            print(f"joinbench: join {j.index}'s inputs were not made again "
                  f"alike", file=sys.stderr)
            failed += 1
            continue
        want = cell.reference.expected(inputs)
        del inputs
        bad = False
        for field in cell.reference.FIELDS:
            gap = _gap(j.line, field, want[field])
            gaps[f"{field}_gap"] = max(gaps[f"{field}_gap"], gap)
            bad |= gap > limits[f"{field}_gap"]
        failed += bad
    return gaps, failed
