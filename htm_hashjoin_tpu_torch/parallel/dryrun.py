"""The multi-device dry run (counterpart of ``dryrun_multichip`` in the JAX
package's ``__graft_entry__.py``): one distributed join step over an
n-shard mesh on tiny shapes, with the same checks.

    python -c "from htm_hashjoin_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(8)"

On one card, eight shards need a device-mapping file that wraps them onto
it (``8 0 1 2 3 4 5 6 7`` in ``$HTM_DEVICE_MAPPING``).
"""

from __future__ import annotations

import torch

from ..utils.device import entry_device
from ..utils.validate import check
from .dist_join import build_dist_join_fn
from .mesh import make_mesh, shard_relation


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run ONE distributed join step over an n_devices mesh: row-sharded
    relations, murmur-hash all_to_all repartition, sampled heavy-hitter
    skew handling, psum match/conservation reduction; then the forced
    overflow repair, and for an even n >= 4 both again on a (2, n/2)
    mesh.  Raises AssertionError when a check fails."""
    dev = entry_device(device, "dryrun_multichip")
    mesh = make_mesh((n_devices,), device=dev)
    n = 128 * n_devices
    gen = torch.Generator().manual_seed(0)
    rk = (torch.randperm(n, generator=gen) + 1).to(torch.int32).to(dev)
    sk = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    res = build_dist_join_fn(mesh, n, n, skew_handling=True)(
        shard_relation(rk, mesh), shard_relation(sk, mesh))
    matches = int(res.matches)
    check(matches == n, f"dryrun expected {n} matches, got {matches}")
    check(int(res.input_sum_r) == int(res.output_sum_r),
           "conservation violated")

    # forced-overflow residual repair: an undersized capacity factor makes
    # send buckets overflow everywhere; the cooperative repair round must
    # join the residuals EXACTLY (zero drops)
    res_r = build_dist_join_fn(mesh, n, n, capacity_factor=0.3,
                               residual_repair=True)(
        shard_relation(rk, mesh), shard_relation(sk, mesh))
    check(int(res_r.matches) == n,
           f"repair dryrun expected {n} matches, got {int(res_r.matches)}")
    check(int(res_r.repaired_r) > 0, "overflow never fired — not exercised")
    check(int(res_r.dropped_r) == 0 and int(res_r.dropped_s) == 0,
           "the repair dryrun dropped tuples")

    if n_devices % 2 == 0 and n_devices >= 4:
        # hierarchical 2-stage exchange over a ("host", "chip") mesh
        mesh2 = make_mesh((2, n_devices // 2), ("host", "chip"), device=dev)
        rk2, sk2 = shard_relation(rk, mesh2), shard_relation(sk, mesh2)
        res2 = build_dist_join_fn(mesh2, n, n, skew_handling=True)(rk2, sk2)
        check(int(res2.matches) == n, f"hierarchical dryrun expected {n} "
               f"matches, got {int(res2.matches)}")
        # hierarchical + forced overflow: both exchange stages spill into
        # the repair round
        res2r = build_dist_join_fn(mesh2, n, n, capacity_factor=0.3,
                                   residual_repair=True)(rk2, sk2)
        check(int(res2r.matches) == n,
               f"hier repair dryrun expected {n}, got {int(res2r.matches)}")
        check(int(res2r.dropped_r) == 0 and int(res2r.dropped_s) == 0,
               "the hierarchical repair dryrun dropped tuples")
