"""The multijoin's probe kernel (``csrc/multijoin_probe.cu``) on the card:
against its plain version bit for bit in both output columns and the head
(several units a block, empty units, ragged rows and blocks that start
and end inside a 16-byte quad, inputs that are not 16-byte aligned, keys
outside the build's range that void the certificate, negative keys that do
not, the cell's full 2^28-row probe split against its 2^24-key build in
8 worker blocks); then the benchmark's Wisconsin cell cut to 2^22 ⋈ 2^24
through the joiner: every worker block on the kernel's route
(``probeKernelBlocks`` 8, 8 launches), its line equal to the torch route's
on the same tables and to the plain reference, and a probe key past the
build's range sending the join back to the torch route.

Needs a CUDA device and nvcc; elsewhere every test skips.  The file imports
no jax:

    python -m pytest tests/test_torch_cuda_multijoin_probe.py --noconftest -m gpu -q
"""

import pytest
import torch

from joinbench import cells
from htm_hashjoin_tpu_torch.ops import multijoin_probe as mp
from htm_hashjoin_tpu_torch.wisconsin import joiners as PJ

pytestmark = pytest.mark.gpu

NAME = "wisconsin_independent_2e24x2e28.fk_uniform"
ARGV = ["--rSize", str(1 << 22), "--sSize", str(1 << 24)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def inputs(n, kmin, r, dev, seed, off=0, outside=0):
    """``n`` keys drawn over R's ``r`` keys from ``kmin`` (sorted within
    runs of 4096, as a split leaves each unit key-ordered), ``outside`` of
    them past kmax, a selected column and R's payload; each column a view
    ``off`` rows into its buffer."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    keys = torch.randint(kmin, kmin + r, (n + off,), generator=g, device=dev,
                         dtype=torch.int32)
    runs = keys[off:off + n - n % 4096].view(-1, 4096)
    runs.copy_(torch.sort(runs, dim=1).values)
    keys[off:off + 16:3] = -1
    if outside:
        pos = torch.randint(off, off + n, (outside,), generator=g, device=dev)
        keys[pos] = kmin + r + 7
    col = torch.randint(-2**31, 2**31 - 1, (n + off,), generator=g,
                        device=dev, dtype=torch.int32)
    payload = torch.randint(-2**31, 2**31 - 1, (r + off,), generator=g,
                            device=dev, dtype=torch.int32)
    return keys[off:], col[off:], payload[off:]


def both(keys, col, payload, kmin, kmax, blocks, cap, out_off=0):
    """The kernel's and the plain version's outputs and heads over the
    worker blocks ``blocks`` ([(start, unit offsets)])."""
    dev = keys.device
    U = max(len(ub) for _, ub in blocks) - 1
    outs = []
    for fn in (mp.multijoin_probe, mp.multijoin_probe_ref):
        buf = torch.full((2, cap + out_off), 7, dtype=torch.int32, device=dev)
        ob, op = buf[0, out_off:], buf[1, out_off:]
        heads = mp.new_heads(len(blocks), U, dev)
        for b, (a0, ub) in enumerate(blocks):
            ub = ub + [ub[-1]] * (U + 1 - len(ub))
            fn(keys, col, payload, kmin, kmax, a0, ub[-1],
               torch.tensor(ub, dtype=torch.int64, device=dev), ob, op,
               heads[b])
        outs.append((ob, op, heads))
    torch.cuda.synchronize()
    return outs


CASES = [
    # (case, n, kmin, r, blocks, outside, misaligned by)
    ("one block of one unit", 1 << 20, 1, 1 << 16, [(0, [0, 1 << 20])], 0,
     0),
    ("ragged units and blocks", 1_000_003, 5, 100_000,
     [(0, [0, 1, 1, 99_999, 400_001]),
      (400_001, [0, 3, 300_000, 300_000, 600_002])], 0, 0),
    ("a row past the blocks", 4099, 1, 4096, [(1, [0, 5, 4097])], 0, 0),
    ("keys past kmax void the flag", 3_000_001, 1, 1 << 18,
     [(0, [0, 1_000_000, 1_500_000]), (1_500_000, [0, 1_500_001])], 5, 0),
    ("inputs one row off 16 bytes", 1_000_001, 1, 1 << 16,
     [(0, [0, 77, 500_000]), (500_000, [0, 500_001])], 0, 1),
    ("outputs one row off 16 bytes", 1_000_001, 1, 1 << 16,
     [(2, [0, 999_999])], 3, "out"),
]


@pytest.mark.parametrize("case,n,kmin,r,blocks,outside,off", CASES,
                         ids=[c[0] for c in CASES])
def test_the_kernel_matches_its_plain_version(dev, case, n, kmin, r, blocks,
                                              outside, off):
    keys, col, payload = inputs(n, kmin, r, dev, 3, off=off if off != "out"
                                else 0, outside=outside)
    if off == 1:
        assert keys.data_ptr() % 16 and payload.data_ptr() % 16
    before = mp.LAUNCHES
    (ob, op, hd), (wb, wp, wh) = both(
        keys, col, payload, kmin, kmin + r - 1, blocks, n + 5,
        out_off=1 if off == "out" else 0)
    assert mp.LAUNCHES == before + len(blocks)
    assert torch.equal(ob, wb) and torch.equal(op, wp)
    assert torch.equal(hd, wh)
    for b, (a0, ub) in enumerate(blocks):     # the head, counted here
        k = keys[a0:a0 + ub[-1]]
        hit = (k >= kmin) & (k < kmin + r)
        assert int(hd[b, -2]) == int(hit.sum())
        assert int(hd[b, -1]) == int(not (~hit & (k >= 0)).any())
    if case == "keys past kmax void the flag":
        assert (hd[:, -1] == 0).any()


def test_the_kernel_at_the_cells_full_probe(dev):
    """The cell's probe at full size: 2^28 fk_uniform keys over R's 2^24,
    split by the independent partitioner on the card (K7), probed in the
    joiner's 8 worker blocks over its 64 partitions."""
    from htm_hashjoin_tpu_torch import wisconsin as P
    n, r = 1 << 28, 1 << 24
    g = torch.Generator(device=dev)
    g.manual_seed(2**31 + 5)
    keys = torch.randint(1, r + 1, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    rid = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    node = {"algorithm": "independent", "pagesize": 1 << 22, "attribute": 1}
    hash_node = {"fn": "modulo", "range": [1, r], "buckets": 64,
                 "skipbits": 17}
    parts = P.partitioner_factory(node, hash_node, 8).split(
        P.Table(P.Schema.create(("long", "long")), [keys, rid], 1 << 22))
    del keys, rid
    units = [(int(a), int(a + z)) for a, z in zip(parts.offsets, parts.sizes)
             if z]
    blocks = []
    for ulo, uhi in PJ._balance_unit_blocks(units, 8):
        a0 = units[ulo][0]
        blocks.append((a0, [a - a0 for a, _ in units[ulo:uhi]]
                       + [units[uhi - 1][1] - a0]))
    assert len(blocks) == 8 and len(units) == 64
    payload = torch.randperm(r, device=dev).to(torch.int32) + 1
    (ob, op, hd), (wb, wp, wh) = both(parts.table.columns[0],
                                      parts.table.columns[1], payload, 1, r,
                                      blocks, n)
    assert torch.equal(ob, wb) and torch.equal(op, wp)
    assert torch.equal(hd, wh)
    assert int(hd[:, -2].sum()) == n and (hd[:, -1] == 1).all()


def cell_line(cell, seed, index, dev):
    """One join of the cell's tables ``(seed, index)``, and the plain
    reference's numbers for them."""
    entry = cell.entry
    tables = entry.make(cell, entry.prepare(cell, seed, dev), index, dev)
    want = cell.reference.expected(tables)
    return entry.join(cell, tables), want


def test_the_cell_runs_every_worker_block_through_the_kernel(dev,
                                                            monkeypatch):
    cell = cells.load(NAME, ARGV)
    seed = 2**31 + 77
    cell_line(cell, seed, 1, dev)                      # builds, warms up
    before = mp.LAUNCHES
    line, want = cell_line(cell, seed, 0, dev)
    assert mp.LAUNCHES == before + 8
    assert line["probeKernelBlocks"] == 8 and line["kvSplits"] == 2
    assert line["probeSchedule"]["units"] == 64
    assert len(line["probeSchedule"]["workerMicros"]) == 8
    assert {f: line[f] for f in cell.reference.FIELDS} == want
    monkeypatch.setattr(PJ, "_on_card", lambda keys: False)
    torch_line, _ = cell_line(cell, seed, 0, dev)
    assert torch_line["probeKernelBlocks"] == 0
    for f in (*cell.reference.FIELDS, "outputBuildSum", "outputProbeSum",
              "outputPairSum", "readbacks"):
        assert line[f] == torch_line[f], f


def test_a_probe_key_past_the_build_takes_the_torch_route(dev):
    """One S key past R's range voids its block's head: the kernel's
    output is dropped (``probeKernelBlocks`` 0) and the torch route's
    join is the answer, the one row fewer."""
    from htm_hashjoin_tpu_torch.wisconsin.driver import join_tables
    cell = cells.load(NAME, ARGV)
    conf = cell.settings["conf"]
    entry = cell.entry
    tables = entry.make(cell, entry.prepare(cell, 2**31 + 78, dev), 0, dev)
    tables.probe.columns[0][12345] = (1 << 22) + 1
    want = cell.reference.expected(tables)
    before = mp.LAUNCHES
    line = join_tables(conf, tables.build, tables.probe).to_dict()
    assert mp.LAUNCHES == before + 8
    assert line["probeKernelBlocks"] == 0
    assert line["outputRows"] == (1 << 24) - 1
    assert {f: line[f] for f in cell.reference.FIELDS} == want
