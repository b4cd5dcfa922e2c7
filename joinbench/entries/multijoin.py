"""The Wisconsin multijoin's own driver, the entry of the cells whose
configuration names it: ``wisconsin.driver.join_tables`` on two tables
made fresh for each join, held to ``multijoin_reference.py``'s four
numbers.

The configuration file gives ``conf``, a file of the port's
``wisconsin.CONF_DIR`` (the reference's conf, run as it is), and the sizes
it holds (``r_size``, ``s_size``); the traffic file gives the key
generator of each side (``r``, ``s``: ``gen/<name>.py``) and an empty
``argv``.  Each table is what the conf's ``generate: true`` stores
(``WriteTable.generate``): two int32 columns under the conf's schema, the
key and the 1-based row id.  The keys come from the traffic's generators
on the join's own ``(seed, index)`` streams, the same draws as
``join_step``'s on the same traffic, in place of the conf's fixed seeds.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import types

import torch
from htm_hashjoin_tpu_torch.wisconsin import CONF_DIR, parse_conf
from htm_hashjoin_tpu_torch.wisconsin.driver import join_tables, page_size
from htm_hashjoin_tpu_torch.wisconsin.schema import Schema
from htm_hashjoin_tpu_torch.wisconsin.table import Table

from joinbench import gen, loop

TRAFFIC_KEYS = frozenset({"argv", "r", "s", "why"})
SIDES = (("r", "build"), ("s", "probe"))


def _sizes(extra_argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="multijoin", add_help=False)
    p.add_argument("--rSize", type=int)
    p.add_argument("--sSize", type=int)
    return p.parse_args(list(extra_argv))


def shrink(conf: dict, r_size: int, s_size: int) -> dict:
    """The conf at |R| = ``r_size`` (R's keys and the alphabet) and |S| =
    ``s_size``, for tests on the CPU: a hash group over [1, old alphabet]
    then covers [1, ``r_size``], its skipbits as many bits lower as the
    alphabet lost, so that every partition still holds keys."""
    old = conf["build"]["alphabet-size"]
    lost = max(0, int(math.log2(old / r_size)))
    conf["build"]["relation-size"] = conf["build"]["alphabet-size"] = r_size
    conf["probe"]["relation-size"] = s_size
    conf["probe"]["alphabet-size"] = r_size
    for node in (conf["partitioner"]["hash"], conf["hash"]):
        if list(node["range"]) == [1, old]:
            node["range"] = [1, r_size]
            node["skipbits"] = max(0, node.get("skipbits", 0) - lost)
    return conf


def load(config: dict, traffic: dict, extra_argv=()) -> dict:
    """The cell's settings: the parsed conf, the sizes and the generator
    modules.  ``extra_argv`` (``--rSize``, ``--sSize``) shrinks the sizes
    (``shrink``); without it the conf must hold the configuration file's.
    The conf's tables have to be (key, row id) joined on the key, with the
    row id selected on both sides: what the reference works out."""
    if traffic["argv"]:
        raise ValueError(f"the multijoin entry takes no argv from its "
                         f"traffic; got {traffic['argv']}")
    conf = parse_conf(os.path.join(CONF_DIR, config["conf"]))
    for side in ("build", "probe"):
        node = conf[side]
        if (tuple(node["schema"]), int(node.get("jattr", 1)),
                [int(x) for x in node.get("select", [])]) != (
                    ("long", "long"), 1, [2]):
            raise ValueError(f"{config['conf']}: the {side} side is not "
                             f"(key, row id) joined on the key, row id "
                             f"selected")
    sizes = (conf["build"]["relation-size"], conf["probe"]["relation-size"])
    if sizes != (config["r_size"], config["s_size"]):
        raise ValueError(f"{config['conf']} gives |R| {sizes[0]}, |S| "
                         f"{sizes[1]}; the configuration file says "
                         f"{config['r_size']}, {config['s_size']}")
    args = _sizes(extra_argv)
    if args.rSize or args.sSize:
        conf = shrink(conf, args.rSize or sizes[0], args.sSize or sizes[1])
    return {"conf": conf, "r_size": conf["build"]["relation-size"],
            "s_size": conf["probe"]["relation-size"],
            "r_gen": gen.load(traffic["r"]), "s_gen": gen.load(traffic["s"])}


@dataclasses.dataclass
class State:
    seed: int


def prepare(cell, seed: int, device) -> State:
    return State(seed)


def table_bytes(state: State) -> int:
    return 0


@dataclasses.dataclass
class Tables:
    """A join's two tables.  ``join_tables`` may free their columns, so
    the tuples and the fingerprint are taken when they are made."""
    build: Table
    probe: Table
    tuples: int
    prints: tuple

    def fingerprint(self) -> tuple:
        return self.prints

    # the columns the reference reads, while the tables hold them
    r_keys = property(lambda self: self.build.columns[0])
    r_rows = property(lambda self: self.build.columns[1])
    s_keys = property(lambda self: self.probe.columns[0])
    s_rows = property(lambda self: self.probe.columns[1])


def make(cell, state: State, index, device) -> Tables:
    """Join ``index``'s tables, the keys from its own generators'
    streams."""
    settings, conf = cell.settings, cell.settings["conf"]
    domain = types.SimpleNamespace(r_size=conf["build"]["alphabet-size"])
    tables = []
    for side, name in SIDES:
        n = settings[f"{side}_size"]
        rng = gen.generator(state.seed, device, index, side)
        keys = settings[f"{side}_gen"].keys(n, domain, rng, None)
        rows = torch.arange(1, n + 1, dtype=torch.int32, device=keys.device)
        tables.append(Table(Schema.create(conf[name]["schema"]),
                            [keys, rows], page_size(conf, name)))
    build, probe = tables
    return Tables(build, probe, build.num_rows + probe.num_rows,
                  (loop.fingerprint(build.columns[0]),
                   loop.fingerprint(probe.columns[0])))


def join(cell, inputs: Tables) -> dict:
    """The timed call: the multijoin's timed phases and its line."""
    return join_tables(cell.settings["conf"], inputs.build,
                       inputs.probe).to_dict()
