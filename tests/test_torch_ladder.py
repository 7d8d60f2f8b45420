"""The port's ladder mode (crypto/gpu_verifier.py: prepare_batch,
verify_kernel_plain, GpuVerifier(mode="ladder")) against the JAX package's
(crypto/tpu_verifier.py: prepare_batch, verify_kernel) and the CPU oracle,
on the CPU.

Inputs: the RFC 8032 vectors, the smoke's fixed adversarial rows
(`crypto/adversarial.py`: A.y >= p, a non-residue A.y, x = 0
with sign 1, a small-order and the identity A, S >= L, a wrong length, a
swapped key) and items signed from numpy-seeded keys with seeded
corruptions, each at B = 8, a JAX bucket.

The JAX side is one jitted function, compiled once for the module (about
100 s cold): it returns both decompressed points with their ok flags, the
ladder's accumulator and `verify_kernel`'s verdict. Keep this file on one
xdist worker (`--dist loadfile`).

Tolerance: exact everywhere. Staged arrays byte for byte; points after
`to_canonical`, limb for limb; bitmaps item for item.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_pbft_tpu.crypto import tpu_verifier as jtv
from simple_pbft_tpu.crypto.verifier import BatchItem as JaxItem
from simple_pbft_tpu.ops import edwards as jed
from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
from simple_pbft_tpu_torch.crypto import gpu_verifier as gv
from simple_pbft_tpu_torch.crypto.adversarial import ladder_adversarial_items
from simple_pbft_tpu_torch.crypto.verifier import BatchItem
from simple_pbft_tpu_torch.ops import edwards as ed
from simple_pbft_tpu_torch.ops import field25519 as fe

BATCH = 8

# RFC 8032 §7.1 test vectors 1-3 (pubkey, msg, sig)
RFC8032 = [
    ("d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025", "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


def _rfc_items():
    return [BatchItem(bytes.fromhex(pk), bytes.fromhex(m), bytes.fromhex(s))
            for pk, m, s in RFC8032]


def _adversarial_items():
    return [it for _, it in ladder_adversarial_items()]


def _signed_items(seed: int = 6):
    """8 items of 4 numpy-seeded signers: every other one corrupted (a
    flipped S or R bit, another message, a swapped key, in turn)."""
    rng = np.random.default_rng(seed)
    seeds = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(4)]
    items = []
    for j in range(BATCH):
        sd = seeds[j % 4]
        msg = bytes(rng.integers(0, 256, 12, dtype=np.uint8))
        sig = bytearray(ref.sign(sd, msg))
        pub = ref.public_key(sd)
        kind = j // 2 if j % 2 else -1
        if kind == 0:
            sig[32 + int(rng.integers(0, 28))] ^= 1 << int(rng.integers(0, 8))
        elif kind == 1:
            sig[int(rng.integers(0, 32))] ^= 1 << int(rng.integers(0, 8))
        elif kind == 2:
            msg += b"!"
        elif kind == 3:
            pub = ref.public_key(seeds[(j + 1) % 4])
        items.append(BatchItem(pub, msg, bytes(sig)))
    return items


BATCHES = {"rfc8032": _rfc_items, "adversarial": _adversarial_items, "signed": _signed_items}


def _jax_ladder(a_y, a_sign, r_y, r_sign, s_bits, k_bits, precheck):
    a_pt, ok_a = jed.decompress(a_y, a_sign)
    r_pt, ok_r = jed.decompress(r_y, r_sign)
    acc = jed.double_scalar_mul_base(s_bits, k_bits, jed.point_neg(a_pt))
    verdict = jtv.verify_kernel(a_y, a_sign, r_y, r_sign, s_bits, k_bits, precheck)
    return a_pt, ok_a, r_pt, ok_r, acc, verdict


@pytest.fixture(scope="module")
def jax_ladder():
    """items -> the JAX package's staging (padded to B = 8) and the jitted
    wrapper's outputs as numpy, cached per batch name."""
    fn = jax.jit(_jax_ladder)
    cache = {}

    def run(name):
        if name not in cache:
            items = BATCHES[name]()
            prep = jtv.prepare_batch([JaxItem(i.pubkey, i.msg, i.sig) for i in items])
            padded = prep.padded(BATCH)
            out = jax.block_until_ready(fn(*(jnp.asarray(a) for a in padded.arrays())))
            cache[name] = (items, prep, padded, [np.asarray(o) for o in out])
        return cache[name]

    return run


def _canonical_point(p) -> np.ndarray:
    """(4, 17, B) limbs (numpy or torch) -> every coordinate canonical."""
    t = torch.as_tensor(np.array(p))
    return fe.to_canonical(t.transpose(0, 1)).transpose(0, 1).numpy()


def _port_arrays(prep):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in prep.arrays()]


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_prepared_batch_byte_identical_to_jax(jax_ladder, name):
    """Exact: every staged array equal to JAX's in dtype, shape and bytes,
    before and after padding to the bucket."""
    items, jprep, jpadded, _ = jax_ladder(name)
    prep = gv.prepare_batch(items)
    assert prep.n == jprep.n == len(items)
    for got, want in ((prep, jprep), (prep.padded(BATCH), jpadded)):
        for a, b in zip(got.arrays(), want.arrays()):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    assert prep.s_bits.shape == (256, len(items)) and prep.s_bits.dtype == np.int32


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_decompress_and_ladder_equal_jax(jax_ladder, name):
    """Exact after to_canonical: A and R decompressed, their ok flags, and
    the ladder's accumulator [S]B + [k](-A), also for invalid A."""
    _, _, padded, (ja, jok_a, jr, jok_r, jacc, _) = jax_ladder(name)
    a_y, a_sign, r_y, r_sign, s_bits, k_bits, _ = _port_arrays(padded)
    a_pt, ok_a = ed.decompress(a_y, a_sign)
    r_pt, ok_r = ed.decompress(r_y, r_sign)
    acc = ed.double_scalar_mul_base(s_bits, k_bits, ed.point_neg(a_pt))
    np.testing.assert_array_equal(ok_a.numpy(), jok_a)
    np.testing.assert_array_equal(ok_r.numpy(), jok_r)
    for got, want in ((a_pt, ja), (r_pt, jr), (acc, jacc)):
        np.testing.assert_array_equal(_canonical_point(got), _canonical_point(want))


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_bitmap_equals_jax_and_oracle(jax_ladder, name):
    """Exact: verify_kernel_plain's bitmap (and GpuVerifier's, on the CPU)
    equals JAX verify_kernel's and the oracle's, item for item."""
    items, _, padded, out = jax_ladder(name)
    n = len(items)
    want = out[-1][:n].tolist()
    oracle = [ref.verify(i.pubkey, i.msg, i.sig) for i in items]
    got = gv.verify_kernel_plain(*_port_arrays(padded))
    assert got.dtype == torch.bool and got.shape == (BATCH,)
    assert got[:n].tolist() == want == oracle
    assert not got[n:].any()  # padding rows: precheck False
    assert gv.GpuVerifier(device="cpu", mode="ladder").verify_batch(items) == oracle


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_jax_staged_arrays_feed_the_port(jax_ladder, name):
    """Exact: the JAX package's staged arrays, unchanged, through
    verify_kernel (CPU tensors: the plain version) give JAX's verdicts, and
    its affine accumulator is JAX's after canonical reduction."""
    _, _, padded, out = jax_ladder(name)
    arrays = _port_arrays(padded)
    np.testing.assert_array_equal(gv.verify_kernel(*arrays).numpy(), out[-1])
    _, xy = gv.verify_kernel_plain(*arrays, affine=True)
    jacc = torch.from_numpy(np.array(out[4]))
    zinv = fe.invert(jacc[2])
    want = torch.cat([fe.to_canonical(fe.mul(jacc[0], zinv)),
                      fe.to_canonical(fe.mul(jacc[1], zinv))])
    np.testing.assert_array_equal(xy.numpy(), want.numpy())


# GpuVerifier(device="cpu", mode="ladder"), after tests/test_tpu_verifier.py


@pytest.fixture(scope="module")
def verifier():
    return gv.GpuVerifier(device="cpu", mode="ladder")


def _signed(i: int, msg: bytes):
    seed = bytes([i]) * 32
    return BatchItem(ref.public_key(seed), msg, ref.sign(seed, msg))


def test_ladder_rfc8032_vectors(verifier):
    """Exact: every RFC 8032 vector verifies."""
    assert verifier.verify_batch(_rfc_items()) == [True] * len(RFC8032)


def test_ladder_bitmap_positions_and_adversarial(verifier):
    """Exact: verdict positions map 1:1 to items and agree with the oracle
    on every adversarial case."""
    good = [_signed(i, b"vote %d" % i) for i in range(4)]
    bad_sig = bytearray(good[0].sig)
    bad_sig[1] ^= 0x40
    noncanon_s = good[2].sig[:32] + (
        (int.from_bytes(good[2].sig[32:], "little") + ref.L).to_bytes(32, "little"))
    items = [
        good[0],
        BatchItem(good[0].pubkey, good[0].msg, bytes(bad_sig)),  # flipped bit
        good[1],
        BatchItem(good[1].pubkey, b"forged", good[1].sig),  # wrong msg
        BatchItem(good[2].pubkey, good[2].msg, noncanon_s),  # S >= L
        BatchItem(good[3].pubkey[:16], good[3].msg, good[3].sig),  # bad len
        BatchItem(b"\xff" * 32, good[3].msg, good[3].sig),  # y >= p
        good[3],
    ]
    got = verifier.verify_batch(items)
    oracle = [ref.verify(i.pubkey, i.msg, i.sig) for i in items]
    assert got == oracle == [True, False, True, False, False, False, False, True]


def test_ladder_swapped_keys_rejected(verifier):
    a, b = _signed(1, b"m1"), _signed(2, b"m2")
    items = [BatchItem(b.pubkey, a.msg, a.sig), BatchItem(a.pubkey, b.msg, b.sig)]
    assert verifier.verify_batch(items) == [False, False]


def test_ladder_bucket_padding_indifferent(verifier):
    """Verdicts must not depend on padding rows (batch of 3 -> bucket 8)."""
    items = [_signed(i, b"pad %d" % i) for i in range(3)]
    assert verifier.verify_batch(items) == [True, True, True]
    assert verifier.bucket_hits.get(8, 0) >= 1


def test_ladder_empty_batch(verifier):
    assert verifier.verify_batch([]) == []


def test_ladder_mode_keeps_no_bank():
    """No bank, config "ladder", no fallback rows, shape capacity 0,
    devledger rows of mode "ladder", and warming accepts a key population;
    the window stays a fused-mode knob."""
    from simple_pbft_tpu_torch import devledger

    v = gv.GpuVerifier(device="cpu", mode="ladder")
    assert v._bank is None and v.config == "ladder"
    prep, fallback = v.prepare([_signed(1, b"x")])
    assert isinstance(prep, gv.PreparedBatch) and fallback == []
    v.warm_for_population([_signed(i, b"k").pubkey for i in range(3)], max_sweep=8)
    row = devledger.recent(1)[-1]
    assert row["mode"] == "ladder" and row["bucket"] == 8
    assert row["bytes_up"] == sum(a.nbytes for a in prep.padded(8).arrays())
    snap = v.shape_snapshot()
    assert snap["config"] == "ladder" and snap["warmed"]
    assert v.shape_signatures == {("ladder", 4, 8, 0)}
    assert snap["kernel_launches_after_warm"]["ladder_verify"] == 0
    with pytest.raises(ValueError, match="fused-mode knob"):
        gv.GpuVerifier(device="cpu", mode="ladder", window=5)
