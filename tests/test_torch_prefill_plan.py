"""The bf16 paged prefill kernel's split plan (``paged_prefill.split_plan``):
how one slot's keys — its earlier pool rows, then the chunk's own keys —
are cut into ranges, one per block along the grid's split axis.  Checked
on the shapes the card tests and ``chip_smoke.py`` run: every live key
lies in exactly one split, no split is empty, a split holds whole key
tiles, and at ``chip_smoke.py``'s timed shape (smollm_360m's heads, a
128-token chunk after 640 earlier rows) the grid fills an H100's 132
SMs."""
import pytest
import torch

from repro_torch.kernels.paged_prefill import (KEY_TILE, MAX_SPLITS,
                                               Q_TILE, split_plan)
from test_torch_cuda import PREFILL_CASES, PREFILL_EDGE_CASES

torch.set_num_threads(1)  # xdist workers share the cores

H100_SMS = 132
# chip_smoke.py's PREFILL_TIMED: (window, start, C, chunk_len, K, G, hd,
# page_size, n_pages, num_pages)
PREFILL_TIMED = (0, 640, 128, 128, 5, 3, 64, 16, 64, 80)


def _slot_keys(case):
    """(prev, n_chunk): the pool rows the chunk sees, then its own keys,
    as the wrapper counts them."""
    window, start, C, clen, K, G, hd, page_size, n_pages, _ = case
    prev = min(start, window) if window else start
    return max(0, min(prev, n_pages * page_size)), clen


def _check_plan(prev, n_chunk, q_rows, K):
    total = prev + n_chunk
    n_split, split_keys = split_plan(prev, n_chunk, q_rows, K, sms=H100_SMS)
    assert 1 <= n_split <= MAX_SPLITS and split_keys >= KEY_TILE
    assert split_keys % KEY_TILE == 0
    ranges = [(s * split_keys, min((s + 1) * split_keys, total))
              for s in range(n_split)]
    assert all(lo < hi for lo, hi in ranges), f"empty split in {ranges}"
    owners = [0] * total
    for lo, hi in ranges:
        for key in range(lo, hi):
            owners[key] += 1
    assert owners == [1] * total
    return -(-q_rows // Q_TILE) * K * n_split


@pytest.mark.parametrize("case", PREFILL_CASES + PREFILL_EDGE_CASES
                         + [PREFILL_TIMED])
def test_split_plan_covers_every_key_once(case):
    _, _, C, _, K, G, _, _, _, _ = case
    prev, n_chunk = _slot_keys(case)
    blocks = _check_plan(prev, n_chunk, C * G, K)
    if case == PREFILL_TIMED:
        assert blocks >= H100_SMS, f"{blocks} blocks on {H100_SMS} SMs"


@pytest.mark.parametrize("prev,n_chunk,q_rows,K", [
    (100_000, 128, 64, 1), (8191, 1, 8, 1), (0, 1, 3, 1), (640, 0, 384, 5)])
def test_split_plan_long_and_degenerate_slots(prev, n_chunk, q_rows, K):
    """A context far longer than the card is wide stays within the
    merge's MAX_SPLITS; one key, or no chunk key, still gets a plan."""
    _check_plan(prev, n_chunk, q_rows, K)


# pixtral_12b's longest-context chunk (chip_smoke.py phase 19): 128
# tokens after 640 rows, 8 KV heads, G 4 (512 query rows a KV head)
PREFILL_PIXTRAL = (0, 640, 128, 128, 8, 4, 128, 16, 64, 80)


def test_split_plan_fills_the_card_at_the_g4_chunk():
    prev, n_chunk = _slot_keys(PREFILL_PIXTRAL)
    blocks = _check_plan(prev, n_chunk, 128 * 4, 8)
    assert blocks >= H100_SMS
