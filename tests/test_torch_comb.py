"""The port's fused comb engine (ops/comb.py) against the JAX package's.

Same seeded numpy inputs into both packages, on the CPU:

- the fused tables are byte-identical;
- the port's plain accumulate (the CPU route of `fused_accumulate`) is
  limb-identical to JAX `fused_accumulate` with accum="xla" and with
  accum="pallas" (the Pallas kernel in interpret mode);
- batch inversion above CHAIN_WIDTH matches Python's pow(z, p-2, p);
- the whole wire kernel gives the JAX kernel's verdicts.

The CUDA kernel itself runs only on a card: its comparison with the plain
version is here too, and skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_pbft_tpu.ops import comb as jcomb
from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
from simple_pbft_tpu_torch.ops import comb
from simple_pbft_tpu_torch.ops import field25519 as fe

RPK = comb.NPOS * comb.FWINDOW  # rows per key at w=4


@pytest.fixture(scope="module")
def tables():
    """(3 * RPK, 64) int32 fused tables of three keys, built by the port."""
    pts = [ref.point_decompress(ref.public_key(bytes([i + 1]) * 32)) for i in range(3)]
    return np.concatenate([comb.fused_table_np(p, 4) for p in pts]), pts


def _windows(seed: int, batch: int, n_keys: int):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 16, (comb.NPOS, batch), dtype=np.int32)
    k = rng.integers(0, 16, (comb.NPOS, batch), dtype=np.int32)
    s[:, 0] = 0  # an all-zero scalar: every row is the identity entry
    k[:, 1] = 15  # all-ones nibbles: the last entry of every window
    base = (rng.integers(0, n_keys, batch) * RPK).astype(np.int32)
    return s, k, base


def test_fused_tables_byte_identical(tables):
    got, pts = tables
    want = np.concatenate([jcomb.fused_table_np(p, 4) for p in pts])
    assert got.dtype == np.int32 and got.shape == (3 * RPK, comb.ROW)
    assert got.tobytes() == want.tobytes()


def test_window_decoders_match_jax():
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (16, 32), dtype=np.uint8)
    data[0, :] = 0xFF
    np.testing.assert_array_equal(comb.nibbles_major_np(data), jcomb.nibbles_major_np(data))
    for w in (4, 5, 6):
        got = comb.windows_major_np(data, w)
        np.testing.assert_array_equal(got, jcomb.windows_major_np(data, w))
        assert got.shape == (comb.npos_for(w), 16)
    np.testing.assert_array_equal(comb.ref_identity_limbs(), jcomb.ref_identity_limbs())


def test_affine_niels_rows_match_jax():
    pts = [ref.point_mul(i + 2, ref.B) for i in range(5)] + [ref.IDENTITY]
    np.testing.assert_array_equal(
        comb._batch_affine_niels_np(pts), jcomb._batch_affine_niels_np(pts)
    )


@pytest.mark.parametrize("accum", ["xla", "pallas"])
def test_plain_accumulate_limb_identical_to_jax(tables, accum):
    flat, _ = tables
    s, k, base = _windows(7, 8, 3)
    want = np.asarray(jcomb.fused_accumulate(
        jnp.asarray(s), jnp.asarray(k), jnp.asarray(base), jnp.asarray(flat),
        accum=accum,
    ))
    got = comb.fused_accumulate(
        torch.from_numpy(s), torch.from_numpy(k), torch.from_numpy(base),
        torch.from_numpy(flat),
    )
    assert got.dtype == torch.int32 and got.shape == (4, fe.NLIMB, 8)
    np.testing.assert_array_equal(got.numpy(), want.reshape(4, fe.NLIMB, 8))


def test_accumulate_equals_scalar_multiples(tables):
    """The accumulator is [S]B + [k](−A) as a group element."""
    flat, pts = tables
    s, k, base = _windows(8, 4, 3)
    acc = comb.fused_accumulate(
        torch.from_numpy(s), torch.from_numpy(k), torch.from_numpy(base),
        torch.from_numpy(flat),
    ).numpy()
    for lane in range(4):
        sv = sum(int(s[i, lane]) << (4 * i) for i in range(comb.NPOS))
        kv = sum(int(k[i, lane]) << (4 * i) for i in range(comb.NPOS))
        a = pts[int(base[lane]) // RPK]
        want = ref.point_add(ref.point_mul(sv, ref.B), ref.point_mul(kv, comb._point_neg(a)))
        got = tuple(fe._limbs_to_int_np(acc[c][:, lane : lane + 1]) % ref.P for c in range(4))
        assert ref.point_equal(got, want), lane


def test_batch_invert_above_chain_width():
    rng = np.random.default_rng(3)
    vals = [1, 2, ref.P - 1] + [
        int.from_bytes(bytes(r), "little") % (ref.P - 1) + 1
        for r in rng.integers(0, 256, (253, 32), dtype=np.uint8)
    ]
    z = np.stack([fe._int_to_limbs_np(v) for v in vals], axis=1)
    assert z.shape[1] == 256 > comb.CHAIN_WIDTH
    inv = fe.to_canonical(comb.batch_invert(torch.from_numpy(z))).numpy()
    for i, v in enumerate(vals):
        assert fe._limbs_to_int_np(inv[:, i : i + 1]) == pow(v, ref.P - 2, ref.P), i


def test_batch_invert_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        comb.batch_invert(torch.ones((17, 12), dtype=torch.int32))


def test_wire_kernel_verdicts_match_jax(tables):
    """End to end on device tensors: S‖k‖R wire bytes -> verdicts."""
    flat, pts = tables
    seeds = [bytes([i + 1]) * 32 for i in range(3)]
    rows, a_idx = [], []
    for j in range(8):
        key = j % 3
        msg = b"wire %d" % j
        sig = bytearray(ref.sign(seeds[key], msg))
        if j == 5:
            sig[3] ^= 1  # corrupt R
        k = ref.challenge_scalar(bytes(sig[:32]), ref.public_key(seeds[key]), msg)
        rows.append(bytes(sig[32:]) + k.to_bytes(32, "little") + bytes(sig[:32]))
        a_idx.append(key)
    wire = np.frombuffer(b"".join(rows), np.uint8).reshape(8, 96).copy()
    a_idx = np.array(a_idx, np.int32)
    pre = np.ones(8, bool)
    pre[6] = False
    want = np.asarray(jcomb.fused_verify_wire_kernel(
        jnp.asarray(wire), jnp.asarray(a_idx), jnp.asarray(flat), jnp.asarray(pre)
    ))
    got = comb.fused_verify_wire_kernel(
        torch.from_numpy(wire), torch.from_numpy(a_idx), torch.from_numpy(flat),
        torch.from_numpy(pre),
    ).numpy()
    assert got.tolist() == want.tolist() == [True] * 5 + [False, False, True]


def test_kernel_wrapper_refuses_cpu_tensors(tables):
    flat, _ = tables
    idx = torch.zeros((comb.NPOS, 8), dtype=torch.int32)
    before = comb.accumulate_kernel.launches
    with pytest.raises(ValueError):
        comb.accumulate_kernel(idx, torch.from_numpy(flat))
    assert comb.accumulate_kernel.launches == before


def test_cuda_kernel_equals_plain_version(tables):
    """The hand-written kernel is limb-identical to madd_loop_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    flat, _ = tables
    dev = torch.device("cuda")
    f_flat = torch.from_numpy(flat).to(dev)
    for batch in (8, 1000):
        s, k, base = _windows(batch, batch, 3)
        idx = comb.accumulate_index(
            torch.from_numpy(s).to(dev), torch.from_numpy(k).to(dev),
            torch.from_numpy(base).to(dev),
        ).contiguous()
        before = comb.accumulate_kernel.launches
        got = comb.accumulate_kernel(idx, f_flat)
        torch.cuda.synchronize()
        assert comb.accumulate_kernel.launches == before + 1
        want = comb.madd_loop_plain(idx, f_flat).reshape(4 * fe.NLIMB, batch)
        assert torch.equal(got, want)
