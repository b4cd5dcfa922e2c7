"""The Wisconsin split's pack and unpack kernels (``csrc/split_pack.cu``) on
the card: each against its plain version bit for bit (the benchmark cell's
layout, no shard term, pages that are no power of two or shorter than four
rows, n = n_pad and n ragged, n not a multiple of 4, keys outside the
hash's range, inputs that are not 16-byte aligned); then the card's
independent and parallel splits at 2^22 + 5 rows, through the kernels and
K7, equal to the same splits with the plain versions on the same tensors in
keys, payloads, sizes, offsets and permutation, with the launches counted.

Needs a CUDA device and nvcc; elsewhere every test skips.  The file imports
no jax:

    python -m pytest tests/test_torch_cuda_split_pack.py --noconftest -m gpu -q
"""

import pytest
import torch

from htm_hashjoin_tpu_torch.constants import MAXI32
from htm_hashjoin_tpu_torch.ops import global_sort_kv as gkv
from htm_hashjoin_tpu_torch.ops import rot_pack as rp
from htm_hashjoin_tpu_torch.ops import rot_unpack as ru

pytestmark = pytest.mark.gpu

# (case, n, n_pad, (vmin, skip, b, restbits, bias_bits), shards)
CASES = [
    ("cell layout, 2^22-row pages, padded", 3 * (1 << 22) + 5, 1 << 24,
     (1, 17, 6, 19, 3), rp.Shards(1 << 22, 8)),
    ("cell layout, n = n_pad", 1 << 23, 1 << 23, (1, 17, 6, 19, 3),
     rp.Shards(1 << 22, 8)),
    ("cell layout, restbits 18", 100_003, 131_072, (1, 17, 6, 18, 3),
     rp.Shards(4096, 8)),
    ("no shard term", 5_000_001, 1 << 23, (1, 12, 11, 13, 0), None),
    ("pages of 1000 rows, 5 shards", 1_000_003, 1 << 20, (1, 17, 6, 19, 3),
     rp.Shards(1000, 5)),
    ("pages of 3 rows", 4099, 8192, (1, 17, 6, 19, 3), rp.Shards(3, 8)),
    ("n = n_pad, not a multiple of 4", 4099, 4099, (-5, 4, 4, 20, 2),
     rp.Shards(64, 3)),
    ("n = n_pad = 3", 3, 3, (1, 17, 6, 19, 3), rp.Shards(2, 8)),
]
IDS = [c[0] for c in CASES]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def columns(n, vmin, dev, seed, full_range=False):
    """Keys in the hash's range (or any int32: the bits must still agree)
    and a payload of any int32."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lo, hi = (-2**31, 2**31 - 1) if full_range else (vmin, vmin + (1 << 24))
    keys = torch.randint(lo, hi, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    payload = torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                            device=dev, dtype=torch.int32)
    return keys, payload


def plain_pack(keys, payload, shards, vmin, skip, b, restbits, bias_bits,
               n_pad):
    """The pack's plain version on the card's tensors."""
    n = keys.numel()
    bias = keys if shards is None else shards.ids(n, keys.device)
    t = rp.rot_pack_ref(keys, bias, vmin, skip, b, restbits, bias_bits,
                        n_pad)
    if payload is None or n == n_pad:
        return t, payload
    return t, torch.cat([payload, payload.new_zeros(n_pad - n)])


@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("case,n,n_pad,layout,shards", CASES, ids=IDS)
def test_pack_kernel_matches_plain(dev, case, n, n_pad, layout, shards,
                                   full_range):
    keys, payload = columns(n, layout[0], dev, 5, full_range)
    before = rp.LAUNCHES
    t, pay = rp.rot_pack(keys, payload, shards, *layout, n_pad)
    torch.cuda.synchronize()
    assert rp.LAUNCHES == before + 1
    want_t, want_pay = plain_pack(keys, payload, shards, *layout, n_pad)
    assert torch.equal(t, want_t)
    assert torch.equal(pay, want_pay)
    assert (pay is payload) == (n == n_pad)
    assert torch.equal(t[n:], torch.full((n_pad - n,), MAXI32,
                                         dtype=torch.int32, device=dev))


@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("case,n,n_pad,layout,shards", CASES, ids=IDS)
def test_unpack_kernel_matches_plain(dev, case, n, n_pad, layout, shards,
                                     full_range):
    """On K7's output for the packed keys (or on any int32, whose bits must
    agree all the same)."""
    keys, payload = columns(n, layout[0], dev, 6, full_range)
    t, pay = plain_pack(keys, payload, shards, *layout, n)
    t_s, pay_s = gkv.global_sort_kv_ref(t, pay)
    nparts = 1 << layout[2]
    before = ru.LAUNCHES
    key_s, pay_out, so = ru.rot_unpack(t_s, pay_s, *layout, nparts)
    torch.cuda.synchronize()
    assert ru.LAUNCHES == before + 1
    want = ru.rot_unpack_ref(t_s, pay_s, *layout, nparts)
    assert torch.equal(key_s, want[0]) and pay_out is pay_s
    assert torch.equal(so, want[2])
    if not full_range:
        assert torch.equal(torch.sort(key_s).values, torch.sort(keys).values)


@pytest.mark.parametrize("kernel", ["pack", "unpack"])
def test_kernels_read_inputs_that_are_not_16_byte_aligned(dev, kernel):
    """A view one row in: the kernels' row-at-a-time instance."""
    n, layout, shards = 100_001, (1, 17, 6, 19, 3), rp.Shards(1000, 8)
    keys, payload = columns(n + 1, 1, dev, 7)
    keys, payload = keys[1:], payload[1:]
    assert keys.data_ptr() % 16 and payload.data_ptr() % 16
    if kernel == "pack":
        got = rp.rot_pack(keys, payload, shards, *layout, 1 << 17)
        want = plain_pack(keys, payload, shards, *layout, 1 << 17)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    else:
        t = plain_pack(keys, None, shards, *layout, n + 1)[0][1:]
        got = ru.rot_unpack(t, payload, *layout, 64)
        want = ru.rot_unpack_ref(t, payload, *layout, 64)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])


def test_the_pack_kernel_refuses_a_shard_tensor(dev):
    keys = torch.ones(4096, dtype=torch.int32, device=dev)
    before = rp.LAUNCHES
    with pytest.raises(ValueError, match="Shards"):
        rp.rot_pack(keys, None, keys, 1, 17, 6, 19, 3, 4096)
    with pytest.raises(ValueError, match="shift past 31"):
        rp.rot_pack(keys, None, None, 1, 20, 12, 19, 0, 4096)
    assert rp.LAUNCHES == before


@pytest.mark.parametrize("algo", ["independent", "parallel"])
def test_the_card_split_equals_its_plain_route(dev, monkeypatch, algo):
    """2^22 + 5 rows (2^23 padded: K7's value column is the pack's copy):
    the kernels' split and the same split with the plain versions, K7 in
    both, equal in every output; one pack, K7 and unpack launch a split,
    and one more pack when the permutation is read."""
    from htm_hashjoin_tpu_torch import wisconsin as P
    from htm_hashjoin_tpu_torch.wisconsin import partitioner as wpart
    n = (1 << 22) + 5
    keys, _ = columns(n, 1, dev, 8)
    rid = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    node = {"algorithm": algo, "pagesize": 1 << 19, "attribute": 1}
    hash_node = {"fn": "modulo", "range": [1, 1 << 24], "buckets": 64,
                 "skipbits": 17}
    table = P.Table(P.Schema.create(("long", "long")), [keys, rid], 1 << 19)
    split = P.partitioner_factory(node, hash_node, 8).split

    before = (rp.LAUNCHES, gkv.LAUNCHES, ru.LAUNCHES, wpart.KV_SPLITS)
    got = split(table)
    torch.cuda.synchronize()
    assert (rp.LAUNCHES, gkv.LAUNCHES, ru.LAUNCHES, wpart.KV_SPLITS) == \
        tuple(x + 1 for x in before)
    got_perm = got.perm
    assert rp.LAUNCHES == before[0] + 2

    monkeypatch.setattr(wpart, "rot_pack", plain_pack)
    monkeypatch.setattr(wpart, "rot_unpack", ru.rot_unpack_ref)
    before = (rp.LAUNCHES, gkv.LAUNCHES, ru.LAUNCHES)
    want = split(table)
    want_perm = want.perm
    assert (rp.LAUNCHES, gkv.LAUNCHES, ru.LAUNCHES) == \
        (before[0], before[1] + 1, before[2])

    assert (got.sizes == want.sizes).all()
    assert (got.offsets == want.offsets).all()
    for g, w in zip(got.table.columns, want.table.columns):
        assert torch.equal(g, w)
    assert torch.equal(got_perm, want_perm)
