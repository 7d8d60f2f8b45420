"""The port's cost model (simple_pbft_tpu_torch/crypto/costmodel.py)
against the JAX package's: every mode, window, bucket and row layout,
the shape-key parser and the ledger roll-up, and the JAX anchor points."""

import pytest

from simple_pbft_tpu.crypto import costmodel as jax_cost
from simple_pbft_tpu.ops import comb as jax_comb
from simple_pbft_tpu_torch.crypto import costmodel
from simple_pbft_tpu_torch.ops import comb as port_comb

MODES = ("fused", "wire", "comb", "ladder", "pairing")
SHAPES = {
    "ed25519:fused/w4/b8": {"dispatches": 2, "items": 10, "pad_items": 6},
    "bls:pairing/w0/b4": {"dispatches": 1, "items": 4, "pad_items": 0},
    "garbage-key": {"dispatches": 9},
}


@pytest.fixture
def row_packing():
    """Sets both packages' row layout; restores each one's after."""
    before = jax_comb.PACKED, port_comb.PACKED

    def use(on):
        jax_comb.use_row_packing(on)
        port_comb.use_row_packing(on)

    yield use
    jax_comb.use_row_packing(before[0])
    port_comb.use_row_packing(before[1])


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_shape_cost_equals_the_jax_model(packed, row_packing):
    row_packing(packed)
    assert port_comb.ROW == jax_comb.ROW == (32 if packed else 64)
    for mode in MODES:
        for window in (4, 5, 6):
            for bucket in (8, 8192):
                want = jax_cost.shape_cost(mode, window, bucket)
                assert costmodel.shape_cost(mode, window, bucket) == want, (
                    mode, window, bucket)
                assert (costmodel.shape_cost(mode, window, bucket, row_bytes=128)
                        == jax_cost.shape_cost(mode, window, bucket, row_bytes=128))


def test_shape_keys_and_rollup_equal_the_jax_model():
    for key in (*SHAPES, "fused/w4/b8", "ed25519:comb/w4/b8192", "nonsense",
                "a:b/c/d", None):
        assert costmodel.parse_shape_key(key) == jax_cost.parse_shape_key(key)
    assert costmodel.gather_bytes_for_shapes(SHAPES) == jax_cost.gather_bytes_for_shapes(SHAPES)
    per_item = costmodel.shape_cost("fused", 4, 8)["gather_bytes_per_item"]
    assert costmodel.gather_bytes_for_shapes(SHAPES) == per_item * 8 * 2
    assert costmodel.parse_shape_key("ed25519:fused/w4/b8")["lane"] == "ed25519"
    assert costmodel.parse_shape_key("fused/w4/b8")["mode"] == "fused"
    assert costmodel.parse_shape_key("nonsense") is None


def test_the_jax_anchor_points_hold_for_the_port():
    """tests/test_devledger.py::test_costmodel_r05_anchor_points, run
    against the port's copy."""
    c5 = costmodel.shape_cost("fused", 5, 8192)
    assert c5["gathers_per_item"] == 52
    assert c5["gather_bytes_per_item"] == 13312
    assert c5["gather_bytes_per_pass"] == 13312 * 8192
    assert c5["madds_per_item"] == 52
    assert costmodel.shape_cost("fused", 6, 8192)["madds_per_item"] == 43
    assert costmodel.shape_cost("comb", 4, 8)["gathers_per_item"] == 128
    assert costmodel.shape_cost("ladder", 4, 8)["gather_bytes_per_item"] == 0
    assert c5["wire_bytes_per_item"] == 101
    assert costmodel.shape_cost("pairing", 0, 4)["gather_bytes_per_item"] == 0


def test_the_only_peak_is_the_cards_measured_gather_rate():
    assert list(costmodel.PEAK_GATHER_GBPS) == ["h100"]
    # a measured rate, under the card's 3,350 GB/s memory rate
    assert 0 < costmodel.PEAK_GATHER_GBPS["h100"] < 3350
