"""The JAX package's Pallas madd loop and its packed and w = 5 verifiers
against the port's plain versions, on the CPU (the Pallas kernel in
interpret mode). Split from tests/test_torch_modes.py so that the JAX
compiles spread over the test run's workers. Every comparison is exact.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_pbft_tpu.crypto import tpu_verifier as jtv
from simple_pbft_tpu.ops import comb as jcomb
from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
from simple_pbft_tpu_torch.crypto import gpu_verifier as gv
from simple_pbft_tpu_torch.crypto.verifier import BatchItem
from simple_pbft_tpu_torch.ops import comb
from simple_pbft_tpu_torch.ops import field25519 as fe


@contextlib.contextmanager
def layout(name: str):
    """Both packages' row layout set to `name`, restored to dense after."""
    packed = name == "packed"
    comb.use_row_packing(packed)
    jcomb.use_row_packing(packed)
    try:
        yield
    finally:
        comb.use_row_packing(False)
        jcomb.use_row_packing(False)


def _signed(i: int, msg: bytes):
    seed = bytes([i]) * 32
    return BatchItem(ref.public_key(seed), msg, ref.sign(seed, msg))


def _oracle(items):
    return [ref.verify(i.pubkey, i.msg, i.sig) for i in items]


@pytest.fixture(scope="module")
def points():
    return [ref.point_decompress(ref.public_key(bytes([i + 1]) * 32)) for i in range(2)]


def _fused_inputs(wbits, batch, seed, rows_per_key):
    rng = np.random.default_rng(seed)
    npos = comb.npos_for(wbits)
    s = rng.integers(0, 1 << wbits, (npos, batch), dtype=np.int32)
    k = rng.integers(0, 1 << wbits, (npos, batch), dtype=np.int32)
    s[:, 0] = 0  # the identity entry at every position
    k[:, 1] = (1 << wbits) - 1  # the last entry of every window
    base = (rng.integers(0, 2, batch) * rows_per_key).astype(np.int32)
    return s, k, base


@pytest.mark.parametrize("wbits,name", [(4, "packed"), (5, "dense"), (5, "packed")])
def test_pallas_accumulate_matches_plain(points, wbits, name):
    """The JAX Pallas madd loop (interpret mode) on the same rows equals
    the port's plain accumulate limb for limb."""
    batch = 8
    with layout(name):
        flat = np.concatenate([comb.fused_table_np(p, wbits) for p in points])
        s, k, base = _fused_inputs(wbits, batch, 60 + wbits, flat.shape[0] // 2)
        want = np.asarray(jcomb.fused_accumulate(
            jnp.asarray(s), jnp.asarray(k), jnp.asarray(base), jnp.asarray(flat),
            window=1 << wbits, accum="pallas",
        )).reshape(4, fe.NLIMB, batch)
        got = comb.fused_accumulate(torch.from_numpy(s), torch.from_numpy(k),
                                    torch.from_numpy(base), torch.from_numpy(flat),
                                    window=1 << wbits)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_window5_matches_oracle():
    """The JAX test's batch through both packages at w = 5."""
    good = [_signed(i, b"w5 %d" % i) for i in range(3)]
    items = good + [BatchItem(good[0].pubkey, b"tampered", good[0].sig)]
    want = jtv.TpuVerifier(mode="fused", window=5).verify_batch(items)
    got = gv.GpuVerifier(device="cpu", mode="fused", window=5).verify_batch(items)
    assert got == want == _oracle(items) == [True, True, True, False]


def test_row_packing_matches_oracle_and_dense():
    """Packed rows at w = 5 through both packages: the bitmap equals the
    dense one, JAX's and the oracle's, invalid rows included."""
    good = [_signed(40 + i, b"pack %d" % i) for i in range(5)]
    bad_sig = bytearray(good[1].sig)
    bad_sig[7] ^= 1
    items = good + [
        BatchItem(good[0].pubkey, b"wrong msg", good[0].sig),
        BatchItem(good[1].pubkey, good[1].msg, bytes(bad_sig)),
    ]
    dense = gv.GpuVerifier(device="cpu", mode="fused", window=5).verify_batch(items)
    with layout("packed"):
        assert comb.ROW == comb.ROW_PACKED
        packed = gv.GpuVerifier(device="cpu", mode="fused", window=5).verify_batch(items)
        want = jtv.TpuVerifier(mode="fused", window=5).verify_batch(items)
    assert packed == dense == want == _oracle(items) == [True] * 5 + [False, False]
