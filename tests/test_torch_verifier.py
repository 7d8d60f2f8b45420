"""GpuVerifier(device="cpu") against the JAX TpuVerifier and the oracle.

The port's verifier runs its whole device path on CPU tensors here (the
accumulate through its plain version). Every batch goes through both
verifiers; the bitmaps must be equal item by item, and equal to the
RFC 8032 oracle.
"""

import numpy as np
import pytest
import torch

from simple_pbft_tpu.crypto import tpu_verifier as jtv
from simple_pbft_tpu_torch import default_device
from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
from simple_pbft_tpu_torch.crypto.gpu_verifier import GpuVerifier, KeyBank
from simple_pbft_tpu_torch.crypto.verifier import (
    BatchItem,
    CpuVerifier,
    NativeEdVerifier,
    kernel_equivalent_cpu_verifier,
)
from simple_pbft_tpu_torch.ops import comb

# RFC 8032 §7.1 test vectors 1-3 (pubkey, msg, sig)
RFC8032_VECTORS = [
    (
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
        "",
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
    ),
    (
        "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
        "72",
        "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
        "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00",
    ),
    (
        "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
        "af82",
        "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
        "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a",
    ),
]


@pytest.fixture(scope="module")
def gpu():
    return GpuVerifier(device="cpu")


@pytest.fixture(scope="module")
def tpu():
    return jtv.TpuVerifier()


def _signed(i: int, msg: bytes):
    seed = bytes([i]) * 32
    return BatchItem(ref.public_key(seed), msg, ref.sign(seed, msg))


def _off_curve_key() -> bytes:
    y = 2
    while ref.point_decompress(y.to_bytes(32, "little")) is not None:
        y += 1
    return y.to_bytes(32, "little")


def _adversarial():
    good = [_signed(i, b"vote %d" % i) for i in range(4)]
    bad_sig = bytearray(good[0].sig)
    bad_sig[1] ^= 0x40  # flipped R byte
    bad_s = bytearray(good[1].sig)
    bad_s[40] ^= 0x08  # flipped S byte
    noncanon_s = good[2].sig[:32] + (
        (int.from_bytes(good[2].sig[32:], "little") + ref.L).to_bytes(32, "little")
    )
    noncanon_r = b"\xed" + b"\xff" * 30 + b"\x7f" + good[3].sig[32:]  # R.y = p
    other = _signed(9, b"vote 3")
    return [
        good[0],
        BatchItem(good[0].pubkey, good[0].msg, bytes(bad_sig)),
        good[1],
        BatchItem(good[1].pubkey, good[1].msg, bytes(bad_s)),
        BatchItem(good[1].pubkey, b"forged", good[1].sig),  # wrong msg
        BatchItem(good[2].pubkey, good[2].msg, noncanon_s),  # S >= L
        BatchItem(good[3].pubkey, good[3].msg, noncanon_r),  # R.y >= p
        BatchItem(other.pubkey, good[3].msg, good[3].sig),  # forged key
        BatchItem(good[3].pubkey[:16], good[3].msg, good[3].sig),  # bad len
        BatchItem(good[3].pubkey, good[3].msg, good[3].sig[:63]),  # bad len
        BatchItem(b"\xff" * 32, good[3].msg, good[3].sig),  # key y >= p
        BatchItem(_off_curve_key(), good[3].msg, good[3].sig),  # off curve
        good[3],
    ]


def test_rfc8032_vectors(gpu, tpu):
    items = [
        BatchItem(bytes.fromhex(pk), bytes.fromhex(msg), bytes.fromhex(sig))
        for pk, msg, sig in RFC8032_VECTORS
    ]
    assert gpu.verify_batch(items) == tpu.verify_batch(items) == [True] * 3


def test_bitmap_positions_and_adversarial(gpu, tpu):
    items = _adversarial()
    got = gpu.verify_batch(items)
    oracle = [ref.verify(i.pubkey, i.msg, i.sig) for i in items]
    assert got == tpu.verify_batch(items) == oracle
    assert got == [True, False, True] + [False] * 9 + [True]


def test_swapped_keys_rejected(gpu, tpu):
    a, b = _signed(1, b"m1"), _signed(2, b"m2")
    items = [BatchItem(b.pubkey, a.msg, a.sig), BatchItem(a.pubkey, b.msg, b.sig)]
    assert gpu.verify_batch(items) == tpu.verify_batch(items) == [False, False]


def test_bucket_padding_indifferent(gpu, tpu):
    """Verdicts must not depend on padding rows (3 -> bucket 8, 9 -> 32)."""
    for n in (3, 9):
        items = [_signed(i % 4, b"pad %d" % i) for i in range(n)]
        assert gpu.verify_batch(items) == tpu.verify_batch(items) == [True] * n


def test_empty_batch(gpu, tpu):
    assert gpu.verify_batch([]) == tpu.verify_batch([]) == []


def test_initial_keys_pins_table_shape_and_warm_is_inert():
    v = GpuVerifier(device="cpu", initial_keys=20)
    assert v._bank._cap == 32  # next power of two
    v.warm(buckets=[8])
    assert len(v._bank._index) == 0  # dummy never registered
    items = [_signed(i, b"pin %d" % i) for i in range(6)]
    assert v.verify_batch(items) == [True] * 6
    assert v._bank._cap == 32
    assert v.device_calls == 2 and v.device_items == 14


def test_keybank_cap_falls_back_to_cpu():
    v = GpuVerifier(device="cpu")
    v._bank = KeyBank(initial_capacity=2, max_keys=2, device="cpu", mode="fused")
    items = [_signed(i, b"cap %d" % i) for i in range(4)]  # 4 distinct keys
    bad = bytearray(items[3].sig)
    bad[2] ^= 4
    items.append(BatchItem(items[3].pubkey, items[3].msg, bytes(bad)))
    assert v.verify_batch(items) == [True, True, True, True, False]
    assert len(v._bank._index) == 2


def test_overbank_fallback_agrees_with_kernel(tpu):
    """Every edge item routed to the over-cap fallback must get the
    kernel's verdict, and the fallback is native/oracle, never OpenSSL."""
    edge_items = _adversarial()
    oracle = [ref.verify(i.pubkey, i.msg, i.sig) for i in edge_items]
    kernel = GpuVerifier(device="cpu").verify_batch(edge_items)
    assert kernel == oracle == tpu.verify_batch(edge_items)
    v = GpuVerifier(device="cpu")
    v._bank = KeyBank(initial_capacity=1, max_keys=1, device="cpu", mode="fused")
    assert v.verify_batch([_signed(99, b"occupier")]) == [True]
    got = v.verify_batch(edge_items)
    assert got == kernel
    assert len(v._bank._index) == 1
    assert isinstance(v._cpu_fb, (NativeEdVerifier, CpuVerifier))
    assert type(kernel_equivalent_cpu_verifier()) is type(v._cpu_fb)


def test_keybank_from_numpy_verifies_like_jax_bank(tpu):
    """A JAX KeyBank's rows and index load into the port unchanged."""
    items = [_signed(i, b"bank %d" % i) for i in range(5)]
    items.append(BatchItem(items[0].pubkey, b"altered", items[0].sig))
    jbank = jtv.KeyBank(initial_capacity=8, mode="fused", window=4)
    for it in items[:5]:
        jbank.lookup(it.pubkey)
    bank = KeyBank.from_numpy(jbank._np, jbank._index, device="cpu", mode="fused")
    assert bank._cap == 8 and bank._index == jbank._index
    for pk, row in jbank._index.items():
        fresh = KeyBank(device="cpu", mode="fused")
        fresh.lookup(pk)
        np.testing.assert_array_equal(bank._np[row], fresh._np[0])
    v = GpuVerifier(device="cpu")
    v._bank = bank
    got = v.verify_batch(items)
    assert got == tpu.verify_batch(items) == [True] * 5 + [False]
    assert len(bank._index) == 5  # nothing rebuilt or added
    assert bank.device_tables().shape == (8 * jbank._rows_per_key, 64)


def test_keybank_from_numpy_rejects_bad_input():
    rows = np.zeros((2, 64 * 256, 64), np.int32)
    with pytest.raises(ValueError):
        KeyBank.from_numpy(rows[:, :10], {}, device="cpu", mode="fused")
    with pytest.raises(ValueError):
        KeyBank.from_numpy(rows, {b"a" * 32: 1}, device="cpu", mode="fused")  # row 0 unused
    with pytest.raises(ValueError):
        KeyBank.from_numpy(rows.astype(np.int64), {}, device="cpu", mode="fused")


def test_default_bank_has_the_jax_banks_mode_and_cap():
    """KeyBank() is a comb bank of 1,024 keys in both packages, whatever
    the device's memory; a fused bank's cap is the JAX bank's too."""
    bank, jbank = KeyBank(device="cpu"), jtv.KeyBank()
    assert bank._rows_per_key == jbank._rows_per_key == 64 * 16
    assert bank._max_keys == jbank._max_keys == 1024
    assert bank._np.shape == jbank._np.shape
    fused = KeyBank(device="cpu", mode="fused")
    assert fused._max_keys == jtv.KeyBank(mode="fused")._max_keys == 512
    capped = KeyBank(initial_capacity=64, max_keys=5, device="cpu")
    assert (capped._max_keys, capped._cap) == (5, 5)  # explicit cap, clamped capacity


def test_default_bank_and_from_numpy_build_comb_tables():
    """A default bank's rows are comb tables equal to a default JAX
    bank's, and from_numpy takes a default JAX bank's rows as they are
    and refuses fused rows unless told the mode."""
    pks = [ref.public_key(bytes([i]) * 32) for i in (3, 4)]
    bank, jbank = KeyBank(device="cpu"), jtv.KeyBank()
    for pk in pks:
        assert bank.lookup(pk) == jbank.lookup(pk)
    np.testing.assert_array_equal(bank._np, jbank._np)
    np.testing.assert_array_equal(bank._np[1], comb.comb_table_np(ref.point_decompress(pks[1])))
    carried = KeyBank.from_numpy(jbank._np, jbank._index, device="cpu")
    assert carried._rows_per_key == jbank._rows_per_key and carried._max_keys == 1024
    fused = jtv.KeyBank(initial_capacity=2, mode="fused")
    fused.lookup(pks[0])
    with pytest.raises(ValueError):
        KeyBank.from_numpy(fused._np, fused._index, device="cpu")
    assert KeyBank.from_numpy(fused._np, fused._index, device="cpu",
                              mode="fused")._index == fused._index


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GpuVerifier()
    with pytest.raises(RuntimeError):
        default_device()
    with pytest.raises(RuntimeError):
        KeyBank()
