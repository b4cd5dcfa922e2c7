"""K1's CUDA kernel against its plain torch version on the card.

Needs a CUDA device and nvcc; elsewhere every test skips.  The file imports
no jax, so it runs where jax is absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -m gpu -q

(``--noconftest``: the suite's conftest configures jax for the CPU.)
"""

import pytest
import torch

from htm_hashjoin_tpu_torch.data.generators import (local_shuffled_keys,
                                                    sorted_keys)
from htm_hashjoin_tpu_torch.joins import banded_backend as bb
from htm_hashjoin_tpu_torch.ops import fused_sort_count as fsc

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def k1_inputs(rkeys, skeys, tile):
    r_flat = bb.to_tiles(rkeys, tile)
    s_pad = bb.prepare_probe_side(skeys, tile)
    _, _, row_off, rows_needed = bb.band_rows(r_flat, skeys, tile)
    return r_flat, s_pad, row_off, rows_needed


@pytest.mark.parametrize("tile", fsc.KERNEL_TILES)
@pytest.mark.parametrize("method,passes,window", [
    ("blocks", 16, 16), ("blocks", 512, 512), ("oddeven", 4, 4),
    ("oddeven", 4, 64), ("bitonic", 1, 4096)])
def test_kernel_matches_plain(dev, tile, method, passes, window):
    n = 3 * tile - 77
    args = k1_inputs(local_shuffled_keys(n, window, tile, dev),
                     sorted_keys(n, dev), tile)
    kw = dict(tile=tile, method=method, passes=passes)
    before = fsc.LAUNCHES
    got = fsc.fused_sort_count(*args, **kw)
    torch.cuda.synchronize()
    assert fsc.LAUNCHES == before + 1
    want = fsc.fused_sort_count_ref(*args, **kw)
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        assert torch.equal(g, w)
    exact = want[1][:, 2] == 0
    assert torch.equal(got[2][exact], want[2][exact])


def test_band_past_probe_end_is_flagged_not_read(dev):
    tile = 8192
    keys = sorted_keys(2 * tile, dev)
    r_flat, s_pad, row_off, rows_needed = k1_inputs(keys, keys, tile)
    row_off[1] = s_pad.numel() // 128 - 8        # band would run past the end
    _, _, counts, flags = fsc.fused_sort_count(
        r_flat, s_pad, row_off, rows_needed, tile=tile, method="bitonic")
    assert flags.tolist() == [0, 2] and counts[1] == 0
    with pytest.raises(ValueError, match="prepare_probe_side"):
        bb.banded_join_pipelined(keys, keys, tile=tile, locality_window=16,
                                 s2d=s_pad[:2 * tile])


def test_join_on_the_card(dev):
    n = (1 << 20) + 77
    out = bb.banded_join_pipelined(local_shuffled_keys(n, 16, 0, dev),
                                   sorted_keys(n, dev), locality_window=16,
                                   unique_both=True)
    assert out.matches == n and not out.resorted
    assert out.output_sum == out.input_sum == n * (n + 1) // 2
