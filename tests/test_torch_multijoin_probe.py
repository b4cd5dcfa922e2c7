"""The multijoin's probe kernel wrapper (``ops/multijoin_probe.py``) on the
CPU: its plain version row by row, the wrapper running it on CPU tensors
without a launch, its argument checks, and the benchmark's Wisconsin cell
at its ``small_argv`` with the card's routes opened on the CPU (the kv
split and the probe kernel's route, through their plain versions), held
exactly to the entry's plain reference, every worker block on the route.
The route's parity with the torch route and the JAX package's joiner is in
``tests/test_torch_wisconsin.py``; the kernel on the card in
``tests/test_torch_cuda_multijoin_probe.py``."""

import numpy as np
import pytest
import torch

from joinbench import cells
from htm_hashjoin_tpu_torch.ops import multijoin_probe as mp
from htm_hashjoin_tpu_torch.wisconsin import joiners as PJ
from htm_hashjoin_tpu_torch.wisconsin import partitioner as PP

CPU = torch.device("cpu")
NAME = "wisconsin_independent_2e24x2e28.fk_uniform"


def block(n=1000, kmin=5, kmax=516, seed=1):
    """Keys mostly in [kmin, kmax], with some outside on both sides and
    negative ones; a payload in key order and a selected column."""
    g = torch.Generator().manual_seed(seed)
    keys = torch.randint(kmin, kmax + 1, (n,), generator=g,
                         dtype=torch.int32)
    keys[[1, 2, 3, n // 2, 7 * n // 10]] = torch.tensor(
        [kmax + 1, kmin - 1, -4, -1, kmax + 1], dtype=torch.int32)
    payload = torch.randint(-2**31, 2**31 - 1, (kmax - kmin + 1,),
                            generator=g, dtype=torch.int32)
    col = torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                        dtype=torch.int32)
    return keys, payload, col


def test_the_plain_version_writes_each_row_at_its_own_index():
    keys, payload, col = block()
    out_b = torch.full((1024,), 7, dtype=torch.int32)
    out_p = out_b.clone()
    ub = torch.tensor([0, 100, 100, 400, 601], dtype=torch.int64)
    head = mp.new_heads(1, 4, CPU)[0]
    start, rows = 299, 601
    got = mp.multijoin_probe_ref(keys, col, payload, 5, 516, start, rows, ub,
                                 out_b, out_p, head)
    assert got is head
    k = keys.numpy().astype(np.int64)
    valid = (k >= 5) & (k <= 516)
    rank = np.where(valid, k - 5, 0)
    rows_ = slice(start, start + rows)
    np.testing.assert_array_equal(out_b[rows_].numpy(),
                                  payload.numpy()[rank[rows_]])
    np.testing.assert_array_equal(out_p[rows_].numpy(), col[rows_].numpy())
    assert (out_b[:start] == 7).all() and (out_b[start + rows:] == 7).all()
    assert (out_p[:start] == 7).all() and (out_p[start + rows:] == 7).all()
    v = valid[rows_]
    want = [v[a:b].sum() for a, b in zip(ub[:-1].tolist(), ub[1:].tolist())]
    assert head.tolist() == want + [v.sum(), 0]    # row 700: key 517


def test_a_negative_key_keeps_the_all_unit_flag():
    keys, payload, col = block()
    out_b, out_p = torch.empty(1000, dtype=torch.int32), \
        torch.empty(1000, dtype=torch.int32)
    ub = torch.tensor([0, 300, 498], dtype=torch.int64)
    # rows 3..500 hold the keys -4 and -1 and no key >= 0 outside the range
    head = mp.multijoin_probe(keys, col, payload, 5, 516, 3, 498, ub, out_b,
                              out_p, mp.new_heads(1, 2, CPU)[0])
    assert head[-1] == 1 and head[-2] == 496 == head[:2].sum()


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    keys, payload, col = block(seed=2)
    ub = torch.tensor([0, 250, 1000], dtype=torch.int64)
    outs = [torch.zeros(1000, dtype=torch.int32) for _ in range(4)]
    heads = mp.new_heads(2, 2, CPU)
    before = mp.LAUNCHES
    mp.multijoin_probe(keys, col, payload, 5, 516, 0, 1000, ub, outs[0],
                       outs[1], heads[0])
    mp.multijoin_probe_ref(keys, col, payload, 5, 516, 0, 1000, ub, outs[2],
                           outs[3], heads[1])
    assert mp.LAUNCHES == before
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])
    assert torch.equal(heads[0], heads[1])


def bad_args(case):
    keys, payload, col = block(n=64)
    args = dict(keys=keys, col=col, payload=payload, kmin=5, kmax=516,
                start=0, rows=64, ubounds=torch.tensor([0, 64]),
                out_build=torch.empty(64, dtype=torch.int32),
                out_probe=torch.empty(64, dtype=torch.int32),
                head=mp.new_heads(1, 1, CPU)[0])
    if case == "int64 keys":
        args["keys"] = keys.long()
    elif case == "a strided column":
        args["col"] = torch.empty(128, dtype=torch.int32)[::2]
    elif case == "columns of two lengths":
        args["col"] = col[:63]
    elif case == "rows past the columns":
        args["start"] = 1
    elif case == "rows past the output":
        args["out_probe"] = args["out_probe"][:60]
    elif case == "int32 unit offsets":
        args["ubounds"] = args["ubounds"].int()
    elif case == "a head of the wrong size":
        args["head"] = torch.zeros(4, dtype=torch.int64)
    elif case == "a key range past the payload":
        args["kmax"] = 517
    elif case == "kmin above kmax":
        args["kmin"], args["kmax"] = 9, 8
    return args


@pytest.mark.parametrize("case", [
    "int64 keys", "a strided column", "columns of two lengths",
    "rows past the columns", "rows past the output", "int32 unit offsets",
    "a head of the wrong size", "a key range past the payload",
    "kmin above kmax"])
def test_the_wrapper_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        mp.multijoin_probe(**bad_args(case))


def test_the_wrapper_raises_on_another_device():
    args = {k: v.to("meta") if isinstance(v, torch.Tensor) else v
            for k, v in bad_args("none").items()}
    with pytest.raises(ValueError, match="cpu or cuda"):
        mp.multijoin_probe(**args)


def test_the_cell_takes_the_route_in_every_worker_block(monkeypatch):
    """The Wisconsin cell at its ``small_argv`` (2^16 ⋈ 2^20) with the kv
    split and the probe kernel's route open on the CPU, as on the card:
    the line equals the plain reference, its probe schedule is 64 units
    in 8 worker blocks, and all 8 took the route."""
    monkeypatch.setattr(PP, "_on_card", lambda keys: True)
    monkeypatch.setattr(PP, "KV_MIN_ROWS", 1 << 16)
    monkeypatch.setattr(PJ, "_on_card", lambda keys: True)
    config = cells.config_file("wisconsin_independent_2e24x2e28")
    cell = cells.load(NAME, config["small_argv"])
    inputs = cell.entry.make(cell, cell.entry.prepare(cell, 2**31 + 99, CPU),
                             0, CPU)
    want = cell.reference.expected(inputs)
    line = cell.entry.join(cell, inputs)
    assert {f: line[f] for f in cell.reference.FIELDS} == want
    assert line["probeKernelBlocks"] == 8
    assert line["probeSchedule"]["units"] == 64
    assert len(line["probeSchedule"]["workerMicros"]) == 8
    assert line["probeSchedule"]["route"] == "perm"
