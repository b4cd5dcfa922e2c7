"""The Wisconsin split's rotation packing around K7 on the CPU
(``ops/rot_pack.py``, ``ops/rot_unpack.py``): on CPU tensors each wrapper
is its plain version and launches nothing; the shard ids follow the
reference's round-robin page split; the unpacking inverts the packing; and
the kernels' layout check refuses what their shifts cannot hold.  The
kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda_split_pack.py``)."""

import numpy as np
import pytest
import torch

from htm_hashjoin_tpu_torch.constants import MAXI32
from htm_hashjoin_tpu_torch.ops import rot_pack as rp
from htm_hashjoin_tpu_torch.ops import rot_unpack as ru

# (case, n, n_pad, (vmin, skip, b, restbits, bias_bits), shards): the
# benchmark cell's layout (64 buckets over keys 1..2^24, 8 shards; pages of
# 4096 rows here, 2^22 in the cell), no shard term, pages that are no power
# of two, pages shorter than four rows, n = n_pad, and n not a multiple of 4
CASES = [
    ("cell layout, padded", 3 * 4096 + 5, 4 * 4096, (1, 17, 6, 19, 3),
     rp.Shards(4096, 8)),
    ("no shard term", 5000, 8192, (1, 12, 11, 13, 0), None),
    ("pages of 1000 rows, 5 shards", 12288, 12288, (1, 17, 6, 19, 3),
     rp.Shards(1000, 5)),
    ("pages of 3 rows", 4099, 8192, (1, 17, 6, 19, 3), rp.Shards(3, 8)),
    ("n = n_pad, not a multiple of 4", 4099, 4099, (-5, 4, 4, 20, 2),
     rp.Shards(64, 3)),
]
IDS = [c[0] for c in CASES]


def inputs(n, vmin, seed=0):
    g = torch.Generator().manual_seed(seed)
    keys = torch.randint(vmin, vmin + (1 << 24), (n,), generator=g,
                         dtype=torch.int32)
    payload = torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                            dtype=torch.int32)
    return keys, payload


@pytest.mark.parametrize("case,n,n_pad,layout,shards", CASES, ids=IDS)
def test_rot_pack_on_cpu_is_its_plain_version(case, n, n_pad, layout,
                                              shards):
    keys, payload = inputs(n, layout[0])
    bias = keys if shards is None else shards.ids(n, keys.device)
    before = rp.LAUNCHES
    t, pay = rp.rot_pack(keys, payload, shards, *layout, n_pad)
    assert rp.LAUNCHES == before
    assert torch.equal(t, rp.rot_pack_ref(keys, bias, *layout, n_pad))
    assert torch.equal(t[n:], torch.full((n_pad - n,), MAXI32,
                                         dtype=torch.int32))
    assert torch.equal(pay[:n], payload) and not pay[n:].any()
    assert (pay is payload) == (n == n_pad)
    t_only, none = rp.rot_pack(keys, None, shards, *layout, n)
    assert none is None and torch.equal(t_only, t[:n])


@pytest.mark.parametrize("case,n,n_pad,layout,shards", CASES, ids=IDS)
def test_rot_unpack_on_cpu_is_its_plain_version(case, n, n_pad, layout,
                                                shards):
    """On sorted packed keys, as K7 hands them over: the plain version's
    keys and bounds, the payload as given, the keys back in partition
    order, and each partition's keys in its bounds."""
    keys, payload = inputs(n, layout[0], seed=1)
    t, pay = rp.rot_pack(keys, payload, shards, *layout, n_pad)
    t_s, order = torch.sort(t[:n], stable=True)
    pay_s = pay[:n][order]
    nparts = 1 << layout[2]
    before = ru.LAUNCHES
    key_s, pay_out, so = ru.rot_unpack(t_s, pay_s, *layout, nparts)
    assert ru.LAUNCHES == before
    want = ru.rot_unpack_ref(t_s, pay_s, *layout, nparts)
    assert torch.equal(key_s, want[0]) and pay_out is pay_s
    assert torch.equal(so, want[2])
    assert torch.equal(key_s, keys[order])
    vmin, skip, b = layout[:3]
    bucket = ((key_s - vmin) >> skip) & ((1 << b) - 1)
    sizes, offsets = so.numpy()
    assert sizes.sum() == n and np.all(offsets[1:] == np.cumsum(sizes)[:-1])
    for p in range(nparts):
        assert torch.all(bucket[offsets[p]:offsets[p] + sizes[p]] == p)


@pytest.mark.parametrize("page_size,nthreads", [(4096, 8), (1000, 5),
                                                (3, 8), (1, 1)])
def test_shards_deal_pages_round_robin(page_size, nthreads):
    n = 9001
    ids = rp.Shards(page_size, nthreads).ids(n, torch.device("cpu"))
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(
        ids.numpy(), (np.arange(n) // page_size) % nthreads)


@pytest.mark.parametrize("layout", [(2**31, 0, 4, 20, 0), (1, 20, 12, 19, 0),
                                    (1, 17, 6, 30, 2), (1, -1, 6, 19, 3)])
def test_the_kernels_layout_check_refuses_wide_shifts(layout):
    with pytest.raises(ValueError, match="rot_pack"):
        rp.check_layout("rot_pack", *layout)
