"""The paged decode kernel's split plan (``paged_attention.split_plan``):
how each (slot, KV head)'s key positions are cut into page-aligned
ranges, one block of a thread-block cluster each.  Checked on the shapes
the card tests and ``chip_smoke.py`` run: every position below
``n_pages · page_size`` lies in exactly one split, splits start on a page
boundary, a cluster holds at most 8 blocks, the plan reads shapes only
(the same plan whatever ``kv_len`` holds), and at ``chip_smoke.py``'s
timed shape (16 slots, smollm_360m's 5 KV heads, 1024-row tables) the
grid gives an H100's 132 SMs at least one block each."""
import pytest
import torch

from repro_torch.kernels.paged_attention import (MAX_SPLITS,
                                                 MIN_SPLIT_KEYS, split_plan)
from test_torch_cuda import DECODE_CASES, DECODE_EDGE_CASES

torch.set_num_threads(1)  # xdist workers share the cores

H100_SMS = 132
# chip_smoke.py's timed decode shape: (B, K, page_size, n_pages)
DECODE_TIMED = (16, 5, 16, 64)
# the serve CLI's tables: 8 slots of 4 pages of 16 rows
DECODE_CLI = (8, 5, 16, 4)


def _shape(case):
    """(B, K, page_size, n_pages) of a card-test case, as the test's page
    table has it: as many pages as the longest slot needs."""
    n_pages = max(1, case.get("n_pages", 0),
                  max(-(-n // case["page_size"]) for n in case["kv_len"]))
    return case["B"], case["K"], case["page_size"], n_pages


def _check_plan(B, K, page_size, n_pages):
    rows = n_pages * page_size
    n_split, split_keys = split_plan(B, K, rows, page_size, sms=H100_SMS)
    assert 1 <= n_split <= MAX_SPLITS
    assert split_keys > 0 and split_keys % page_size == 0
    owners = [0] * rows
    for s in range(n_split):
        for t in range(s * split_keys, min((s + 1) * split_keys, rows)):
            owners[t] += 1
    assert owners == [1] * rows
    if n_split > 1:
        assert -(-rows // n_split) >= MIN_SPLIT_KEYS
    return n_split, split_keys


@pytest.mark.parametrize("shape", [_shape(c) for c in
                                   DECODE_CASES + DECODE_EDGE_CASES]
                         + [DECODE_TIMED, DECODE_CLI])
def test_split_plan_covers_every_row_once(shape):
    _check_plan(*shape)


def test_split_plan_fills_the_card_at_the_timed_shape():
    B, K, page_size, n_pages = DECODE_TIMED
    n_split, split_keys = _check_plan(*DECODE_TIMED)
    assert B * K * n_split >= H100_SMS
    assert split_keys < n_pages * page_size     # the longest slot is split


def test_split_plan_is_one_block_on_short_tables():
    """The serve CLI's 64-row tables are one split: no cluster merge."""
    assert split_plan(8, 5, 64, 16, sms=H100_SMS) == (1, 64)


@pytest.mark.parametrize("kv_len", [[1024] * 16, [0] * 16,
                                    [1, 0, 17, 1024] * 4])
def test_split_plan_reads_shapes_only(kv_len):
    """The plan takes no kv_len: a batch of full, idle or ragged slots at
    one shape has one plan (the kernel clips each split to kv_len)."""
    B, K, page_size, n_pages = DECODE_TIMED
    plan = split_plan(B, K, n_pages * page_size, page_size, sms=H100_SMS)
    assert plan == split_plan(len(kv_len), K, n_pages * page_size,
                              page_size, sms=H100_SMS)
    n_split, split_keys = plan
    for n in kv_len:
        live = [max(0, min(n, (s + 1) * split_keys) - s * split_keys)
                for s in range(n_split)]
        assert sum(live) == n


@pytest.mark.parametrize("B,K,rows,page_size", [
    (1, 1, 100_000 * 16, 16), (1, 1, 8, 8), (64, 8, 4096, 32),
    (1, 1, 5 * 256, 256), (3, 2, 0, 16)])
def test_split_plan_long_and_degenerate_tables(B, K, rows, page_size):
    """A table far longer than the card is wide stays within one cluster;
    one page, huge pages and an empty table still get a plan."""
    n_split, split_keys = split_plan(B, K, rows, page_size, sms=H100_SMS)
    assert 1 <= n_split <= MAX_SPLITS and split_keys % page_size == 0
    assert n_split * split_keys >= rows


# pixtral_12b's engine at context 1024 (chip_smoke.py phase 19): 16 slots,
# 8 KV heads, 64 pages of 16 rows; its G 4 and head dim 128 do not enter
# the plan
DECODE_PIXTRAL = (16, 8, 16, 64)


def test_split_plan_fills_the_card_at_the_g4_engine_shape():
    n_split, split_keys = _check_plan(*DECODE_PIXTRAL)
    assert 16 * 8 * n_split >= H100_SMS
    assert (n_split, split_keys) == (8, 128)
