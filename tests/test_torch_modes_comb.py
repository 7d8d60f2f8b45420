"""The comb mode of the port against the JAX package's, on the CPU: the
separate-table accumulate limb for limb, the tail that takes R as staged
limbs, and the whole verifier's bitmap. Split from
tests/test_torch_modes.py so that the JAX compiles spread over the test
run's workers. Every comparison is exact.
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


def _items(tag: bytes, n_keys: int = 3, n: int = 8):
    """n signed items over n_keys signers, with a wrong message, a flipped
    S bit and a flipped R bit among them."""
    items = [_signed(40 + i % n_keys, tag + b" %d" % i) for i in range(n)]
    it = items[1]
    items[1] = BatchItem(it.pubkey, b"wrong msg", it.sig)
    sig = bytearray(items[2].sig)
    sig[40] ^= 1
    items[2] = BatchItem(items[2].pubkey, items[2].msg, bytes(sig))
    sig = bytearray(items[4].sig)
    sig[3] ^= 8
    items[4] = BatchItem(items[4].pubkey, items[4].msg, bytes(sig))
    return items


def _affine(acc: np.ndarray, lane: int):
    x, y, z = (fe._limbs_to_int_np(acc[c][:, lane : lane + 1]) for c in range(3))
    zi = pow(z, ref.P - 2, ref.P)
    return x * zi % ref.P, y * zi % ref.P


@pytest.fixture(scope="module")
def comb_inputs(points):
    """Two keys' comb tables, the base table and seeded nibbles, B = 8."""
    a_flat = np.concatenate([comb.comb_table_np(p) for p in points])
    rng = np.random.default_rng(77)
    s = rng.integers(0, 16, (comb.NPOS, 8), dtype=np.int32)
    k = rng.integers(0, 16, (comb.NPOS, 8), dtype=np.int32)
    s[:, 0], k[:, 0] = 0, 0
    s[:, 1], k[:, 1] = 15, 15
    base = (rng.integers(0, 2, 8) * comb.NPOS * comb.WINDOW).astype(np.int32)
    return s, k, base, a_flat, comb.base_table()


def test_comb_accumulate_limb_identical_to_jax(comb_inputs, points):
    """comb_accumulate_plain (the CPU route of comb_accumulate) equals
    JAX's comb_accumulate limb for limb and is [S]B + [k](−A); its splits
    over P parts are the same affine points."""
    s, k, base, a_flat, b_flat = comb_inputs
    want = np.asarray(jcomb.comb_accumulate(
        jnp.asarray(s), jnp.asarray(k), jnp.asarray(base), jnp.asarray(a_flat),
        jnp.asarray(b_flat)))
    args = [torch.from_numpy(x) for x in (s, k, base, a_flat, b_flat)]
    got = comb.comb_accumulate(*args)
    np.testing.assert_array_equal(got.numpy(), want)
    for lane in (0, 1, 2):
        sv = sum(int(s[i, lane]) << (4 * i) for i in range(comb.NPOS))
        kv = sum(int(k[i, lane]) << (4 * i) for i in range(comb.NPOS))
        a = points[int(base[lane]) // (comb.NPOS * comb.WINDOW)]
        pt = ref.point_add(ref.point_mul(sv, ref.B), ref.point_mul(kv, comb._point_neg(a)))
        acc = tuple(fe._limbs_to_int_np(want[c][:, lane : lane + 1]) % ref.P for c in range(4))
        assert ref.point_equal(acc, pt), lane
    for parts in (2, 4, 8, 16):
        split = comb.comb_accumulate_plain(*args, parts=parts).numpy()
        for lane in range(8):
            assert _affine(split, lane) == _affine(want, lane), (parts, lane)


def test_comb_tail_limb_entry_matches_jax(comb_inputs):
    """The comb path's tail (R as staged limbs and sign) gives JAX's
    batch-inverted comparison on the same accumulator."""
    s, k, base, a_flat, b_flat = comb_inputs
    p = comb.comb_accumulate(*[torch.from_numpy(x) for x in (s, k, base, a_flat, b_flat)])
    _, xy = comb.encode_and_compare_plain(p, torch.zeros((17, 8), dtype=torch.int32),
                                          torch.zeros(8, dtype=torch.int32),
                                          torch.ones(8, dtype=torch.bool), affine=True)
    r_y = xy[fe.NLIMB:].clone()
    r_sign = (xy[0] & 1).to(torch.int32)
    r_y[:, 3] = (r_y[:, 3] + 1) & fe.MASK  # a wrong y
    r_sign[4] ^= 1  # a wrong sign
    pre = torch.ones(8, dtype=torch.bool)
    pre[5] = False
    got = comb.encode_verdict_limbs(p, r_y, r_sign, pre)
    want = np.asarray(jcomb._encode_and_compare(
        jnp.asarray(p.numpy()), jnp.asarray(r_y.numpy()), jnp.asarray(r_sign.numpy()),
        jnp.asarray(pre.numpy())))
    assert got.tolist() == want.tolist() == [True] * 3 + [False] * 3 + [True] * 2


def test_comb_verify_kernel_bitmap_matches_jax():
    """The comb mode end to end: the port's bitmap equals JAX's
    TpuVerifier(mode="comb") and the oracle's."""
    items = _items(b"comb", n=8)
    want = jtv.TpuVerifier(mode="comb").verify_batch(items)
    v = gv.GpuVerifier(device="cpu", mode="comb")
    got = v.verify_batch(items)
    assert got == want == _oracle(items)
    assert v.shape_snapshot()["config"] == "comb_w4_dense"
