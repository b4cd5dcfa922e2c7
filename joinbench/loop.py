"""One run of a cell: set-up, the measured window, then the check.

Set-up makes what the generators keep for a run and joins one untimed
pair of the cell's own shapes.  The window is a closed loop, one client:
make a fresh pair of relations for join ``i`` from ``(seed, i)``, fence
it, reset the peak-memory counter, then time the port CLI's join step,
``DISPATCH[cfg.algo.value](r, s, cfg)``, up to the synchronised device
after its return.  Joins start until ``seconds`` have passed.  A traced
run profiles the window's first ``TRACED + 1`` joins and reads the last
``TRACED``: the first carries the profiler's own start-up.

Once the window has closed and the program's tensors are freed, a sample
of the window's joins drawn from the seed is made again from its
``(seed, i)``, and the plain reference (``reference.py``) works out the
numbers each line is held to.
"""

from __future__ import annotations

import dataclasses
import random
import sys
import time
import traceback

import torch
from htm_hashjoin_tpu_torch.joins import DISPATCH
from htm_hashjoin_tpu_torch.relation import Relation

from . import gen, reference, trace

TRACED = 5       # joins a traced run reads: the window's second to sixth
SAMPLE = 32      # joins the check makes again and compares
LIMITS = {f"{field}_gap": 0 for field in reference.FIELDS}   # exact


@dataclasses.dataclass
class Join:
    index: int
    seconds: float          # the join's interval
    generate_s: float       # making and fencing its inputs (not timed)
    peak_bytes: int         # peak device memory in it, its inputs included,
                            # the generators' tables (Inputs.table_bytes) not
    tuples: int             # |R| + |S|
    line: dict | None       # the join's line (JoinMetrics.to_dict())
    error: str | None       # what it raised, if it raised
    fingerprint: tuple      # of its inputs, to see them made again alike


@dataclasses.dataclass
class Run:
    """Everything a metric reader reads (``metrics/*.py``)."""
    cell: object
    seed: int
    setup_s: float
    table_bytes: int        # the generators' tables, held through the window
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
    """The cell's relation pairs: join ``index`` of run ``seed`` gets the
    pair its own generators' streams give, on ``device``."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.state = {side: (g.prepare(cell.cfg, seed, self.device)
                             if hasattr(g, "prepare") else None)
                      for side, g in (("r", cell.r_gen), ("s", cell.s_gen))}

    @property
    def table_bytes(self) -> int:
        """Device bytes of what the generators keep for the run (zipf's
        table): live at each join, but the benchmark's, not the join's."""
        return sum(t.numel() * t.element_size() for t in self.state.values()
                   if isinstance(t, torch.Tensor))

    def keys(self, index, side: str) -> torch.Tensor:
        g = self.cell.r_gen if side == "r" else self.cell.s_gen
        n = self.cell.r_size if side == "r" else self.cell.s_size
        rng = gen.generator(self.seed, self.device, index, side)
        return g.keys(n, self.cell.cfg, rng, self.state[side])

    def pair(self, index):
        r = Relation(self.keys(index, "r"))
        s = Relation(self.keys(index, "s"),
                     assume_sorted=self.cell.s_gen.SORTED)
        return r, s


def _join(fn, r, s, cfg, device):
    """(line, error) of one join; the device is synchronised after it."""
    try:
        line = fn(r, s, cfg).to_dict()
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
    ``join_fn`` replaces the port's join step, for the tests and the
    control."""
    cfg = cell.cfg
    fn = join_fn or DISPATCH[cfg.algo.value]
    cuda = torch.device(device).type == "cuda"
    inputs = Inputs(cell, seed, device)
    r, s = inputs.pair("warm-up")
    synchronize(device)
    _join(fn, r, s, cfg, device)
    del r, s
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
            r, s = inputs.pair(i)
            prints = (fingerprint(r.keys), fingerprint(s.keys))
            synchronize(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        with trace.span(trace.JOIN_SPAN, profiling):
            start = time.perf_counter()
            line, err = _join(fn, r, s, cfg, device)
            elapsed = time.perf_counter() - start
        peak = (torch.cuda.max_memory_allocated(device) - inputs.table_bytes
                if cuda else 0)
        joins.append(Join(i, elapsed, start - made, peak,
                          r.num_tuples + s.num_tuples, line, err, prints))
        del r, s
        if profiling and len(joins) == TRACED + 1:
            prof.stop()
            profiling = False
    if profiling:
        prof.stop()
    if cuda:
        torch.cuda.empty_cache()

    traced_joins = (trace.reduce(trace.trace_events(prof))[1:] if traced
                    else None)
    check, failed = _check(joins, inputs, seed)
    return Run(cell=cell, seed=seed, setup_s=setup_s,
               table_bytes=inputs.table_bytes, joins=joins,
               traced=traced_joins, check=check, failed=failed)


def _check(joins, inputs, seed):
    """The worst gap of each number over a sample of the window's joins
    drawn from the seed, and the count of failed joins: those that raised,
    and sampled ones that disagree or whose inputs were not made again
    alike."""
    failed = sum(j.error is not None for j in joins)
    gaps = dict.fromkeys(LIMITS, 0)
    pick = random.Random(gen.stream_seed(seed, "check"))
    for j in sorted(pick.sample(joins, min(SAMPLE, len(joins))),
                    key=lambda j: j.index):
        if j.error is not None:
            continue
        r, s = inputs.pair(j.index)
        if (fingerprint(r.keys), fingerprint(s.keys)) != j.fingerprint:
            print(f"joinbench: join {j.index}'s inputs were not made again "
                  f"alike", file=sys.stderr)
            failed += 1
            continue
        want = reference.expected(r.keys, s.keys)
        del r, s
        bad = False
        for field in reference.FIELDS:
            gap = _gap(j.line, field, want[field])
            gaps[f"{field}_gap"] = max(gaps[f"{field}_gap"], gap)
            bad |= gap > LIMITS[f"{field}_gap"]
        failed += bad
    return gaps, failed
