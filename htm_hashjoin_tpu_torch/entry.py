"""The single-device entry step (counterpart of ``entry()`` in the
JAX package's ``__graft_entry__.py``): the HTM-style bucketed build, the
bucket probe and the conservation sums on 2^16 keys, end to end in one
function.

    python -m htm_hashjoin_tpu_torch.entry

prints the step's three numbers, then runs ``dryrun_multichip(8)`` with
eight shards wrapped onto the visible cards by a device-mapping file, as
the JAX file's ``__main__`` runs both.

The step is torch glue (the JAX package leaves it to XLA): no kernel of
``csrc/`` runs on it.  JAX's ``unique_keys=True`` only picks its
claim-free insert round; on unique keys the claim-round build of
``ops/insert.py`` gives the same table.
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import Callable, Tuple

import torch

from .ops import insert, probe
from .ops.hashing import locality_hash
from .parallel.dryrun import dryrun_multichip
from .parallel.mesh import MAPPING_FILE, mapping_env
from .relation import next_pow2
from .utils.device import entry_device

N = 1 << 16

Step = Callable[[torch.Tensor, torch.Tensor],
                Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def entry(device=None) -> Tuple[Step, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (fn, (rkeys, skeys)): ``fn(rkeys, skeys)`` gives the int64
    scalars (matches, outputSum, failed optimistic inserts) on the keys'
    device, the card unless the caller passes another.  R and S are
    1..2^16, so the step gives (65536, 65536 * 65537 / 2, 0)."""
    dev = entry_device(device, "entry")
    num_buckets = next_pow2(N // 3 + 1)

    def join_step(rkeys: torch.Tensor, skeys: torch.Tensor):
        res = insert.htm_optimistic_build(rkeys, num_buckets, retry=True)
        matches = probe.probe_buckets(res.table, skeys, 3, locality_hash)
        out_sum = (probe.table_sum(res.table)
                   + probe.masked_sum(rkeys, res.pending))
        return (matches, out_sum,
                torch.sum(res.failed_optimistic, dtype=torch.int64))

    rkeys = torch.arange(1, N + 1, dtype=torch.int32, device=dev)
    skeys = torch.arange(1, N + 1, dtype=torch.int32, device=dev)
    return join_step, (rkeys, skeys)


def main() -> int:
    fn, args = entry()
    print("entry:", tuple(int(x) for x in fn(*args)))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, MAPPING_FILE)
        with open(path, "w") as f:
            f.write("8 0 1 2 3 4 5 6 7\n")
        with mapping_env(path):
            dryrun_multichip(8)
    print("dryrun_multichip(8): ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
