"""The least time of a verify pass on the H100, from the verifies it
carried: the arithmetic of `chip_smoke.py`'s bounds (`_bound`,
`accumulate_bound`, `tail_bound`), copied so that the yardstick stays
where a change to the program cannot move it.

A pass's least time is the larger of its bytes over the card's memory
rate and its wide products over the card's multiply issue rate (64 int32
lanes an SM a clock at the boost clock). The accumulate reads each
distinct table row it touches once (204 bytes of a dense row are limbs)
and spends 7 field multiplies of 100 wide products on each of its 64
mixed adds an item (fused w=4); the verdict tail is counted at the least
work of the reference's batch inversion. The work is counted from the
items, not from the kernels, so a kernel that is fused or replaced is
held to the same work.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
INT32_OPS_PER_SM_CLOCK = 64
BOOST_HZ = 1.98e9  # H100 SXM maximum SM clock
ROW_PAYLOAD_BYTES = 3 * 17 * 4
WIDE_PRODUCTS_PER_MUL = 100
FIELD_MULS_PER_MADD = 7
SQ_PRODUCTS = 55
TAIL_MULS_PER_LANE = 3 + 2
CHAIN_SQUARES, CHAIN_MULS, CHAIN_WIDTH = 254, 11, 128
TAIL_BYTES_PER_LANE = 3 * 17 * 4 + 32 + 1 + 1
WIRE_BYTES_PER_ITEM = 96 + 4 + 1  # S, k, R; the key row; the precheck
NPOS, ROWS_PER_POS = 64, 256  # fused w = 4: 64 positions of 16 x 16 rows


def least_s(nbytes: float, products: float, sms: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S,
               products / (sms * INT32_OPS_PER_SM_CLOCK * BOOST_HZ))


def accumulate_least_s(batch: int, distinct_rows: int, sms: int) -> float:
    nbytes = batch * WIRE_BYTES_PER_ITEM + distinct_rows * ROW_PAYLOAD_BYTES + 4 * 17 * batch * 4
    products = batch * NPOS * FIELD_MULS_PER_MADD * WIDE_PRODUCTS_PER_MUL
    return least_s(nbytes, products, sms)


def tail_least_s(batch: int, sms: int) -> float:
    chains = -(-batch // CHAIN_WIDTH)
    products = ((batch * TAIL_MULS_PER_LANE + chains * CHAIN_MULS) * WIDE_PRODUCTS_PER_MUL
                + chains * CHAIN_SQUARES * SQ_PRODUCTS)
    return least_s(batch * TAIL_BYTES_PER_LANE, products, sms)


def row_ids(key_index: np.ndarray, s: np.ndarray, k: np.ndarray) -> np.ndarray:
    """(B,) key indices and (B, 32) little-endian S and k -> (B, 64) ids
    of the table rows a fused w = 4 pass reads: one a position, chosen
    by the position's nibble of S and of k."""
    s_nib = np.stack([s & 15, s >> 4], axis=2).reshape(len(s), NPOS).astype(np.int64)
    k_nib = np.stack([k & 15, k >> 4], axis=2).reshape(len(k), NPOS).astype(np.int64)
    pos = np.arange(NPOS, dtype=np.int64)
    return ((key_index.astype(np.int64)[:, None] * NPOS + pos) * ROWS_PER_POS
            + s_nib * 16 + k_nib)


def pass_least_s(rows: np.ndarray, sms: int) -> float:
    """Least time of one pass (accumulate and verdict) whose items read
    `rows` ((B, 64) row ids)."""
    batch = len(rows)
    return (accumulate_least_s(batch, int(np.unique(rows).size), sms)
            + tail_least_s(batch, sms))
