"""The port CLI's join step, the entry of every cell whose configuration
names no other: ``DISPATCH[cfg.algo.value](r, s, cfg)`` on a fresh pair of
int32 key relations, held to ``reference.py``'s three numbers
(``join_step_reference.py``).

The configuration file gives ``argv`` (the port CLI's arguments for the
algorithm and sizes) and the sizes they give (``r_size``, ``s_size``); the
traffic file gives more ``argv`` (the distribution as the port's planner
is told it) and the generator of each side (``r``, ``s``: ``gen/<name>.py``).
The join's ``JoinConfig`` is the port CLI's own parse of the two lists.
"""

from __future__ import annotations

import dataclasses

import torch
from htm_hashjoin_tpu_torch.cli import parse_args
from htm_hashjoin_tpu_torch.joins import DISPATCH
from htm_hashjoin_tpu_torch.relation import Relation

from joinbench import gen, loop

TRAFFIC_KEYS = frozenset({"argv", "r", "s", "why"})


def load(config: dict, traffic: dict, extra_argv=()) -> dict:
    """The cell's settings: the ``JoinConfig`` (``cfg``), the sizes and the
    generator modules.  ``extra_argv`` goes after the cell's own arguments
    (the tests shrink the sizes with it); without it the parsed sizes must
    be the configuration file's."""
    cfg, _ = parse_args([*config["argv"], *traffic["argv"], *extra_argv])
    if not extra_argv and (cfg.r_size, cfg.s_size) != (config["r_size"],
                                                       config["s_size"]):
        raise ValueError(f"argv gives |R| {cfg.r_size}, |S| {cfg.s_size}; "
                         f"the configuration file says {config['r_size']}, "
                         f"{config['s_size']}")
    return {"cfg": cfg, "r_size": cfg.r_size, "s_size": cfg.s_size,
            "r_gen": gen.load(traffic["r"]), "s_gen": gen.load(traffic["s"])}


@dataclasses.dataclass
class State:
    seed: int
    tables: dict            # side: what its generator's ``prepare`` made


def prepare(cell, seed: int, device) -> State:
    """What the generators keep for a run (zipf's table), made once."""
    device, cfg = torch.device(device), cell.settings["cfg"]
    return State(seed, {side: (g.prepare(cfg, seed, device)
                               if hasattr(g, "prepare") else None)
                        for side, g in (("r", cell.settings["r_gen"]),
                                        ("s", cell.settings["s_gen"]))})


def table_bytes(state: State) -> int:
    """Device bytes of the generators' tables: live at each join, but the
    benchmark's, not the join's."""
    return sum(t.numel() * t.element_size() for t in state.tables.values()
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class Pair:
    r: Relation
    s: Relation

    @property
    def tuples(self) -> int:
        return self.r.num_tuples + self.s.num_tuples

    def fingerprint(self) -> tuple:
        return (loop.fingerprint(self.r.keys), loop.fingerprint(self.s.keys))


def make(cell, state: State, index, device) -> Pair:
    """Join ``index``'s relations, from its own generators' streams; S is
    handed over sorted where its generator makes it so."""
    settings = cell.settings

    def keys(side):
        rng = gen.generator(state.seed, device, index, side)
        return settings[f"{side}_gen"].keys(settings[f"{side}_size"],
                                            settings["cfg"], rng,
                                            state.tables[side])
    return Pair(Relation(keys("r")),
                Relation(keys("s"), assume_sorted=settings["s_gen"].SORTED))


def join(cell, inputs: Pair) -> dict:
    """The timed call: the port's join step and its line."""
    cfg = cell.settings["cfg"]
    return DISPATCH[cfg.algo.value](inputs.r, inputs.s, cfg).to_dict()
