"""Relation persistence: the PERSIST_RELATIONS analog.

Counterpart of ``htm_hashjoin_tpu/data/persist.py``, file for file: the
same ``.npz`` (``keys``, optional ``payloads``) and ``.tbl`` (``key|payload``
lines) and the same content-addressed names, so either package reads what
the other wrote.  The reference writes generated relations to disk and
reloads them for reproducible cross-run comparisons
(mc/src/generator.c:25-26,211-224 write; :255-257 load), and Wisconsin
loads ``.tbl`` text files (table.cpp:198-204).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from ..config import JoinConfig
from ..relation import Relation
from ..utils.device import entry_device


def cache_key(cfg: JoinConfig, side: str) -> str:
    """Stable name from the generation-relevant parameters (the reference
    encodes these in file names like 'S_256M_FK_M=16.tbl')."""
    fields = dict(side=side, dist=cfg.data_distr.value,
                  n=cfg.r_size if side == "r" else cfg.s_size,
                  distinct=cfg.distinct_keys, window=cfg.shuffle_range,
                  seed=cfg.seed, zipf=cfg.zipf_param, r_size=cfg.r_size)
    digest = hashlib.sha256(
        json.dumps(fields, sort_keys=True).encode()).hexdigest()[:12]
    return f"{side}_{cfg.data_distr.value}_{fields['n']}_{digest}"


def save_relation(rel: Relation, path: str) -> None:
    """Write ``rel`` (from any device) as ``.tbl`` text when ``path`` ends
    so (payloads 1..n when it has none), else as ``.npz``."""
    keys = rel.keys.cpu().numpy()
    pay = rel.payloads.cpu().numpy() if rel.payloads is not None else None
    if path.endswith(".tbl"):
        if pay is None:
            pay = np.arange(1, keys.shape[0] + 1)
        with open(path, "w") as f:
            for k, p in zip(keys, pay):
                f.write(f"{k}|{p}\n")
        return
    arrays = {"keys": keys}
    if pay is not None:
        arrays["payloads"] = pay
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)


def load_relation(path: str, device=None) -> Relation:
    """Read a relation written by either package onto ``device`` (the card
    when None)."""
    device = entry_device(device, "load_relation")
    if path.endswith(".tbl"):
        data = np.loadtxt(path, delimiter="|", dtype=np.int64, ndmin=2)
        return Relation(torch.from_numpy(data[:, 0].astype(np.int32)).to(device),
                        torch.from_numpy(data[:, 1].astype(np.int32)).to(device))
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        keys = torch.from_numpy(data["keys"]).to(device)
        payloads = (torch.from_numpy(data["payloads"]).to(device)
                    if "payloads" in data.files else None)
    return Relation(keys, payloads)


def cached_relation(cfg: JoinConfig, side: str, cache_dir: str, generate,
                    device=None) -> Relation:
    """Load the relation for (cfg, side) from cache_dir onto ``device`` (the
    card when None), generating (``generate()``, on any device) and
    persisting on a miss (the PERSIST_RELATIONS read-through behavior,
    generator.c:211-257).  A hit and a miss give the same device."""
    device = entry_device(device, "cached_relation")
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, cache_key(cfg, side) + ".npz")
    if os.path.exists(path):
        return load_relation(path, device)
    rel = generate()
    save_relation(rel, path)
    return dataclasses.replace(
        rel, keys=rel.keys.to(device),
        payloads=None if rel.payloads is None else rel.payloads.to(device))
