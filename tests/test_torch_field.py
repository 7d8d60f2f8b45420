"""The port's GF(2^255-19) limb arithmetic against the JAX package's.

Every input is made with numpy from a seed and handed to both
`simple_pbft_tpu.ops.field25519` (JAX, on the CPU) and
`simple_pbft_tpu_torch.ops.field25519` (PyTorch, on the CPU). The two use
the same 17 x 15-bit int32 limbs and the same carry schedule, so their
outputs must be equal LIMB FOR LIMB (exact: integer arithmetic), and the
canonical values must equal Python bigint math.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_pbft_tpu.ops import field25519 as jfe
from simple_pbft_tpu_torch.ops import field25519 as tfe

P = tfe.P_INT
D = 37095705934669439343138083508754565189542113879843219016388785533085940283555
BOUNDARY = [0, 1, 2, 19, P - 1, P - 2, P - 19, 2**254, D]


def _rand_ints(rng, n):
    raw = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    return [int.from_bytes(bytes(r), "little") % P for r in raw]


def _limbs(vals) -> np.ndarray:
    """ints -> (17, n) int32 canonical limbs."""
    return np.stack([tfe._int_to_limbs_np(v % P) for v in vals], axis=1)


def _value(limbs: np.ndarray, i: int) -> int:
    return tfe._limbs_to_int_np(np.asarray(limbs)[:, i : i + 1]) % P


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(2024)
    vals = BOUNDARY + _rand_ints(rng, 23)
    a = _limbs(vals)
    b = _limbs(list(reversed(vals)))
    # relaxed weak form (the hot path's invariant): limbs in [0, 2^15+2^11)
    wa = rng.integers(0, (1 << 15) + (1 << 11), (17, 16), dtype=np.int32)
    wb = rng.integers(0, (1 << 15) + (1 << 11), (17, 16), dtype=np.int32)
    worst = np.full((17, 1), (1 << 15) + (1 << 11) - 1, np.int32)
    return {
        "vals": vals,
        "a": np.concatenate([a, wa, worst], axis=1),
        "b": np.concatenate([b, wb, worst], axis=1),
    }


def _both(fn_name, *arrays, **kw):
    """Run the same op in both packages; return (jax, torch) as numpy."""
    got_j = np.asarray(getattr(jfe, fn_name)(*(jnp.asarray(x) for x in arrays), **kw))
    out_t = getattr(tfe, fn_name)(*(torch.from_numpy(x) for x in arrays), **kw)
    assert out_t.dtype in (torch.int32, torch.bool), (fn_name, out_t.dtype)
    return got_j, out_t.numpy()


@pytest.mark.parametrize(
    "op", ["add", "sub", "mul_padacc", "mul_skew", "_carry_pass", "normalize"]
)
def test_binary_and_carry_ops_limb_identical(operands, op):
    a, b = operands["a"], operands["b"]
    args = (a, b) if op in ("add", "sub", "mul_padacc", "mul_skew") else (a * 37,)
    want, got = _both(op, *args)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["neg", "_ripple", "normalize_strict", "to_canonical"])
def test_unary_ops_limb_identical(operands, op):
    want, got = _both(op, operands["a"])
    np.testing.assert_array_equal(got, want)


def test_mul_small_limb_identical(operands):
    want, got = _both("mul_small", operands["a"], k=2)
    np.testing.assert_array_equal(got, want)


def test_canonical_values_match_bigints(operands):
    vals = operands["vals"]
    a = torch.from_numpy(_limbs(vals))
    b = torch.from_numpy(_limbs(list(reversed(vals))))
    ops = {
        "add": (tfe.add, lambda x, y: x + y),
        "sub": (tfe.sub, lambda x, y: x - y),
        "mul": (tfe.mul, lambda x, y: x * y),
        "mul_padacc": (tfe.mul_padacc, lambda x, y: x * y),
    }
    for name, (fn, exact) in ops.items():
        out = tfe.to_canonical(fn(a, b)).numpy()
        for i, (x, y) in enumerate(zip(vals, reversed(vals))):
            assert _value(out, i) == exact(x, y) % P, (name, i)


def test_mul_worst_case_limbs_do_not_overflow():
    top = torch.full((17, 1), tfe.MASK, dtype=torch.int32)
    for mul in (tfe.mul_padacc, tfe.mul_skew):
        got = tfe.to_canonical(mul(top, top)).numpy()
        assert _value(got, 0) == (((1 << 255) - 1) ** 2) % P


def test_int32_right_shift_is_arithmetic():
    """to_canonical's borrow test needs `>>` to sign-extend on int32."""
    x = torch.tensor([-1, -2, -(1 << 31), 5], dtype=torch.int32)
    assert (x >> 31).tolist() == [-1, -1, -1, 0]
    assert ((x >> 31) & 1).tolist() == [1, 1, 1, 0]
    assert (x >> 31).dtype == torch.int32


def test_two_p_constant_encodes_2p():
    tp = tfe._two_p(torch.zeros((17, 1), dtype=torch.int32)).numpy()
    assert tfe._limbs_to_int_np(tp) == 2 * P


def test_invert_and_pow22523_match_jax_and_bigints():
    rng = np.random.default_rng(5)
    vals = [0, 1, 2, P - 1] + _rand_ints(rng, 4)
    x = _limbs(vals)
    for name, exp in (("invert", P - 2), ("pow22523", (P - 5) // 8)):
        want = np.asarray(jax.jit(getattr(jfe, name))(jnp.asarray(x)))
        got = getattr(tfe, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)
        canon = tfe.to_canonical(torch.from_numpy(got)).numpy()
        for i, v in enumerate(vals):
            assert _value(canon, i) == pow(v, exp, P), (name, i)


def test_predicates_match_jax(operands):
    a = operands["a"]
    # b equals a in value but not in limbs: a + p in relaxed form
    b = np.array(jfe._carry_pass(jnp.asarray(a) + jnp.asarray(jfe.P_LIMBS)[:, None]))
    for name, args in (("eq", (a, b)), ("eq", (a, operands["b"])),
                       ("is_zero", (a,)), ("parity", (a,))):
        want, got = _both(name, *args)
        np.testing.assert_array_equal(got, want)
    assert _both("eq", a, b)[1].all()
    cond = np.arange(a.shape[1]) % 2 == 0
    want = np.asarray(jfe.select(jnp.asarray(cond), jnp.asarray(a), jnp.asarray(b)))
    got = tfe.select(torch.from_numpy(cond), torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("wbits,count", [(4, 64), (5, 52), (15, 17)])
def test_extract_windows_dev_matches_jax_and_numpy(wbits, count):
    rng = np.random.default_rng(wbits)
    data = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    data[0, :] = 0xFF
    data[1, :] = 0
    want = np.asarray(jfe.extract_windows_dev(jnp.asarray(data), wbits, count))
    got = tfe.extract_windows_dev(torch.from_numpy(data), wbits, count)
    assert got.dtype == torch.int32 and got.shape == (count, 24)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tfe.extract_windows_np(data, wbits, count))


def test_numpy_helpers_match_jax():
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (12, 32), dtype=np.uint8)
    for name in ("bytes32_to_limbs_major_np", "bytes32_to_limbs_np", "sign_bits_np"):
        np.testing.assert_array_equal(getattr(tfe, name)(data), getattr(jfe, name)(data))
    for v in BOUNDARY:
        np.testing.assert_array_equal(tfe._int_to_limbs_np(v), jfe._int_to_limbs_np(v))
