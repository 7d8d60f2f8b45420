"""The port's Edwards point addition (ops/edwards.py) against the JAX
package's.

Seeded points in extended coordinates, each scaled by a random nonzero Z
so that no input is affine, go through JAX `edwards.point_add` and the
port's `point_add` on the CPU. Both use the same 17 x 15-bit limbs and the
same formula (add-2008-hwcd-3 with 2d), so the outputs must be equal limb
for limb, and equal to Python's bigint group law as points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_pbft_tpu.ops import edwards as jed
from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
from simple_pbft_tpu_torch.ops import edwards
from simple_pbft_tpu_torch.ops import field25519 as fe


def _points(seed: int, batch: int):
    """`batch` extended points as bigint tuples and as (4, 17, B) limbs;
    lane 0 is the identity, lane 1 the base point."""
    rng = np.random.default_rng(seed)
    pts = [ref.IDENTITY, ref.B]
    while len(pts) < batch:
        k = int.from_bytes(bytes(rng.integers(0, 256, 32, dtype=np.uint8)), "little")
        pts.append(ref.point_mul(k % ref.L, ref.B))
    scaled = []
    for p in pts:
        raw = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        z = int.from_bytes(raw, "little") % (ref.P - 1) + 1
        scaled.append(tuple(c * z % ref.P for c in p))
    limbs = np.stack(
        [np.stack([fe._int_to_limbs_np(c) for c in p]) for p in scaled], axis=-1
    )
    return scaled, limbs.astype(np.int32)


def _value(limbs: np.ndarray, c: int, lane: int) -> int:
    return fe._limbs_to_int_np(limbs[c][:, lane : lane + 1]) % ref.P


@pytest.mark.parametrize("batch", [8, 32])
def test_point_add_limb_identical_to_jax(batch):
    p_int, p = _points(batch, batch)
    q_int, q = _points(batch + 1, batch)
    q[:, :, 5] = p[:, :, 5]  # one lane adds a point to itself
    q_int[5] = p_int[5]
    want = np.asarray(jed.point_add(jnp.asarray(p), jnp.asarray(q)))
    got = edwards.point_add(torch.from_numpy(p), torch.from_numpy(q))
    assert got.dtype == torch.int32 and got.shape == (4, fe.NLIMB, batch)
    np.testing.assert_array_equal(got.numpy(), want)
    out = got.numpy()
    for lane in range(batch):
        r = tuple(_value(out, c, lane) for c in range(4))
        assert ref.point_equal(r, ref.point_add(p_int[lane], q_int[lane])), lane


def test_constants_match_jax():
    np.testing.assert_array_equal(edwards.D2_LIMBS, jed.D2_LIMBS)
    np.testing.assert_array_equal(edwards.IDENTITY, jed.IDENTITY)


# The ladder mode's point functions, after tests/test_field25519.py's
# TestPointOps. JAX runs eagerly here (no jit: one call of decompress costs
# seconds, a compile of it far more). Tolerance: exact, limb for limb where
# both packages reduce alike, and after to_canonical for decompress and
# compress.


def _canonical_point(p) -> np.ndarray:
    t = torch.as_tensor(np.array(p))
    return fe.to_canonical(t.transpose(0, 1)).transpose(0, 1).numpy()


def test_point_double_limb_identical_to_jax():
    p_int, p = _points(11, 8)
    want = np.asarray(jed.point_double(jnp.asarray(p)))
    got = edwards.point_double(torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), want)
    for lane in range(8):
        r = tuple(_value(got.numpy(), c, lane) for c in range(4))
        assert ref.point_equal(r, ref.point_double(p_int[lane])), lane


def test_point_neg_and_select_limb_identical_to_jax():
    """point_neg, and point_select over a 4-entry table with every index
    0..3 and one outside it (which picks entry 0, as in JAX)."""
    p_int, p = _points(12, 8)
    want = np.asarray(jed.point_neg(jnp.asarray(p)))
    got = edwards.point_neg(torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), want)
    for lane in range(8):
        r = tuple(_value(got.numpy(), c, lane) for c in range(4))
        assert ref.point_equal(ref.point_add(r, p_int[lane]), ref.IDENTITY), lane
    table = np.stack([p, _points(13, 8)[1], _points(14, 8)[1], _points(15, 8)[1]])
    idx = np.array([0, 1, 2, 3, 5, 3, 2, 1], np.int32)
    want = np.asarray(jed.point_select(jnp.asarray(idx), jnp.asarray(table)))
    got = edwards.point_select(torch.from_numpy(idx), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)
    for lane, i in enumerate(idx):
        np.testing.assert_array_equal(got.numpy()[..., lane], table[i if i < 4 else 0][..., lane])


def test_compress_decompress_roundtrip_equal_jax():
    """decompress of encoded points equals JAX's after to_canonical, its ok
    is set, and compress gives back the encoding, as JAX's does."""
    pts, _ = _points(16, 8)
    wires = np.stack([np.frombuffer(ref.point_compress(q), np.uint8) for q in pts])
    y_limbs = fe.bytes32_to_limbs_major_np(wires)
    sign = fe.sign_bits_np(wires)
    jpt, jok = jed.decompress(jnp.asarray(y_limbs), jnp.asarray(sign))
    pt, ok = edwards.decompress(torch.from_numpy(y_limbs), torch.from_numpy(sign))
    assert ok.tolist() == np.asarray(jok).tolist() == [True] * 8
    np.testing.assert_array_equal(_canonical_point(pt), _canonical_point(jpt))
    y_out, x_par = edwards.compress(pt)
    jy, jpar = jed.compress(jpt)
    np.testing.assert_array_equal(y_out.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(x_par.numpy(), np.asarray(jpar))
    for lane, q in enumerate(pts):
        enc = int.from_bytes(wires[lane].tobytes(), "little")
        assert fe._limbs_to_int_np(y_out.numpy()[:, lane:lane + 1]) == enc & ((1 << 255) - 1)
        assert int(x_par[lane]) == enc >> 255
        r = tuple(_value(pt.numpy(), c, lane) for c in range(4))
        assert ref.point_equal(r, q), lane


def test_decompress_invalid_equal_jax():
    """ok is False for a non-residue y and for x = 0 with sign 1, as in JAX
    and the oracle; the (garbage) points still equal JAX's."""
    ys = list(range(2, 8)) + [1, 1]
    signs = np.array([0] * 6 + [1, 0], np.int32)
    y_limbs = np.stack([fe._int_to_limbs_np(y) for y in ys], axis=1)
    jpt, jok = jed.decompress(jnp.asarray(y_limbs), jnp.asarray(signs))
    pt, ok = edwards.decompress(torch.from_numpy(y_limbs), torch.from_numpy(signs))
    flags = [ref._recover_x(y, int(s)) is not None for y, s in zip(ys, signs)]
    assert not all(flags) and flags[-2:] == [False, True]
    assert ok.tolist() == np.asarray(jok).tolist() == flags
    np.testing.assert_array_equal(_canonical_point(pt), _canonical_point(jpt))


def test_ladder_constants_match_jax():
    np.testing.assert_array_equal(edwards.SQRT_M1, jed.SQRT_M1)
    np.testing.assert_array_equal(edwards.D_LIMBS, jed.D_LIMBS)
    np.testing.assert_array_equal(edwards.BASE, jed.BASE)
    np.testing.assert_array_equal(fe.ZERO, np.zeros(17, np.int32))
    np.testing.assert_array_equal(fe.ONE, np.eye(17, dtype=np.int32)[0])
