"""The port's other configurations of the madd loop against the JAX
package's, on the CPU: fused windows of 5 and 6 bits, packed 32-word table
rows, and the comb mode.

Same seeded numpy inputs into both packages. Every comparison is exact:

- window extraction and wire-mode row indices equal what JAX builds from
  its host windows, for w = 4, 5, 6;
- KeyBank rows and comb staging arrays are byte-identical in every mode,
  window and layout; a JAX bank carries across with `from_numpy`;
- the plain accumulators (`madd_loop_plain`, `comb_accumulate_plain`) are
  limb-identical to JAX's accumulate, the Pallas kernel in interpret mode
  included, and their splits over P parts (P not dividing the 52 and 43
  positions of w = 5 and 6 too) are the same points;
- verdict bitmaps equal JAX's and the RFC 8032 oracle's.

Tests that flip the row layout restore both packages' switches in
`finally`, as the JAX package's tests do. The Pallas comparisons and the
JAX verifiers at w = 5 are in tests/test_torch_modes_pallas.py, the comb
mode's JAX comparisons in tests/test_torch_modes_comb.py, so that their
JAX compiles spread over a test run's workers.
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

LAYOUTS = ["dense", "packed"]


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


def _oracle(items):
    return [ref.verify(i.pubkey, i.msg, i.sig) for i in items]


def _affine(acc: np.ndarray, lane: int):
    x, y, z = (fe._limbs_to_int_np(acc[c][:, lane : lane + 1]) for c in range(3))
    zi = pow(z, ref.P - 2, ref.P)
    return x * zi % ref.P, y * zi % ref.P


# -- windows and wire-mode indices ------------------------------------------


@pytest.mark.parametrize("wbits", [4, 5, 6])
def test_windows_major_extraction(wbits):
    """The port's windows equal JAX's and reassemble to the scalar."""
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (16, 32), dtype=np.uint8)
    data[0, :] = 0xFF
    out = comb.windows_major_np(data, wbits)
    np.testing.assert_array_equal(out, jcomb.windows_major_np(data, wbits))
    assert out.shape == (comb.npos_for(wbits), 16)
    assert (out < (1 << wbits)).all() and (out >= 0).all()
    for j in range(16):
        v = sum(int(out[i, j]) << (wbits * i) for i in range(out.shape[0]))
        assert v == int.from_bytes(bytes(data[j]), "little")


@pytest.mark.parametrize("wbits", [4, 5, 6])
def test_wire_kernel_matches_host_prep(wbits):
    """wire_index_plain on the (B, 96) wire bytes equals the rows JAX's
    fused_accumulate forms from the host windows of prepare_comb_batch,
    the top window cut at bit 255: byte 32 of S is k's first byte and
    must not leak into S's last window (set to 0xff here)."""
    items = _items(b"wire", n=8)
    jbank = jtv.KeyBank(initial_capacity=8, mode="fused", window=wbits)
    hp, _ = jtv.prepare_comb_batch(items, jbank)
    s_w, k_w, a_idx = hp.s_nib, hp.k_nib, hp.a_idx
    wp, _ = jtv.prepare_wire_batch(items, jbank)
    wire, wa_idx, _ = wp.arrays()
    wire = wire.copy()
    wire[5, :64] = 0xFF  # all-ones scalars: every window at its maximum
    s_w, k_w = s_w.copy(), k_w.copy()
    s_w[:, 5] = jcomb.windows_major_np(wire[5:6, :32], wbits)[:, 0]
    k_w[:, 5] = jcomb.windows_major_np(wire[5:6, 32:64], wbits)[:, 0]
    npos, fw = comb.npos_for(wbits), 1 << (2 * wbits)
    pos = np.arange(npos)[:, None]
    want = a_idx[None, :] * npos * fw + pos * fw + s_w * (1 << wbits) + k_w
    got = comb.wire_index_plain(torch.from_numpy(wire), torch.from_numpy(wa_idx),
                                window=1 << wbits)
    assert got.dtype == torch.int32 and got.shape == (npos, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    top = (1 << (256 - wbits * (npos - 1))) - 1  # the cut top window
    assert int(got[npos - 1, 5] - got[npos - 1, 5] // fw * fw) == top * (1 << wbits) + top


# -- tables, banks and staging ------------------------------------------------


@pytest.mark.parametrize("name", LAYOUTS)
def test_tables_byte_identical(name):
    """comb_table_np, base_table and fused_table_np at w = 5, 6 equal the
    JAX package's byte for byte in both layouts."""
    pt = ref.point_decompress(ref.public_key(b"\x07" * 32))
    with layout(name):
        row = comb.ROW
        assert row == jcomb.ROW == (32 if name == "packed" else 64)
        got = comb.comb_table_np(pt)
        assert got.shape == (comb.NPOS * comb.WINDOW, row)
        assert got.tobytes() == jcomb.comb_table_np(pt).tobytes()
        np.testing.assert_array_equal(comb.base_table(), jcomb.comb_table_np(ref.B))
        assert comb.base_table_device("cpu").shape == (comb.NPOS * comb.WINDOW, row)
        for w in (5, 6):
            got = comb.fused_table_np(pt, w)
            assert got.shape == (comb.npos_for(w) * (1 << 2 * w), row)
            np.testing.assert_array_equal(got, jcomb.fused_table_np(pt, w))
    assert comb.base_table().shape[1] == comb.ROW_DENSE


CONFIGS = [("fused", 4), ("fused", 5), ("fused", 6), ("comb", 4)]


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("mode,wbits", CONFIGS)
def test_keybank_rows_and_comb_staging_byte_identical(mode, wbits, name):
    """KeyBank rows (8 slots, 3 keys) and prepare_comb_batch's arrays
    equal the JAX package's byte for byte."""
    items = _items(b"bank", n=8)
    items.append(BatchItem(bytes(31), b"short key", bytes(64)))
    with layout(name):
        jbank = jtv.KeyBank(initial_capacity=8, mode=mode, window=wbits)
        bank = gv.KeyBank(initial_capacity=8, device="cpu", mode=mode, window=wbits)
        assert (bank.row, bank._rows_per_key) == (comb.ROW, jbank._rows_per_key)
        for it in items[:3]:
            assert bank.lookup(it.pubkey) == jbank.lookup(it.pubkey)
        assert bank._index == jbank._index
        assert bank._np.dtype == jbank._np.dtype and bank._np.shape == jbank._np.shape
        np.testing.assert_array_equal(bank._np, jbank._np)
        got, got_fb = gv.prepare_comb_batch(items, bank)
        want, want_fb = jtv.prepare_comb_batch(items, jbank)
        assert got_fb == want_fb and got.n == want.n
        for a, b in zip(got.padded(16).arrays(), want.padded(16).arrays()):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
        assert got.precheck.tolist() == [True] * 8 + [False]


@pytest.mark.parametrize("name", LAYOUTS)
def test_jax_bank_carries_across_at_window_5(name):
    """A JAX w = 5 bank's rows and index load into the port unchanged,
    and verify as the JAX bank does."""
    items = _items(b"carry", n=8)
    with layout(name):
        jbank = jtv.KeyBank(initial_capacity=8, mode="fused", window=5)
        for it in items[:3]:
            jbank.lookup(it.pubkey)
        bank = gv.KeyBank.from_numpy(jbank._np, jbank._index, device="cpu", mode="fused",
                                     window=5)
        assert bank._index == jbank._index and bank.row == comb.ROW
        v = gv.GpuVerifier(device="cpu", window=5)
        v._bank = bank
        got = v.verify_batch(items)
        assert len(bank._index) == 3  # nothing rebuilt or added
        with pytest.raises(ValueError):  # the other window's shape
            gv.KeyBank.from_numpy(jbank._np, jbank._index, device="cpu", mode="fused",
                                  window=6)
    assert got == _oracle(items)
    if name == "packed":
        with pytest.raises(ValueError):  # the other layout's width
            gv.KeyBank.from_numpy(jbank._np, jbank._index, device="cpu", mode="fused",
                                  window=5)


def test_table_of_the_other_layout_raises():
    """A dense table handed to the packed arithmetic (and back) raises."""
    pt = ref.point_decompress(ref.public_key(b"\x09" * 32))
    dense = torch.from_numpy(comb.fused_table_np(pt, 4))
    idx = torch.zeros((comb.NPOS, 8), dtype=torch.int32)
    with layout("packed"):
        packed = torch.from_numpy(comb.fused_table_np(pt, 4))
        with pytest.raises(ValueError):
            comb.madd_loop_plain(idx, dense)
    with pytest.raises(ValueError):
        comb.madd_loop_plain(idx, packed)


def test_negate_rows_raises_runtime_error_on_packed_layout():
    """An unconditional RuntimeError, not an assert, as in the JAX
    package: dense-negated packed rows would be wrong group elements."""
    with layout("packed"):
        with pytest.raises(RuntimeError, match="dense-layout"):
            comb.negate_rows(torch.zeros((comb.ROW, 2), dtype=torch.int32))
        with pytest.raises(RuntimeError, match="dense rows"):
            gv.GpuVerifier(device="cpu", mode="comb")
    rows = torch.from_numpy(comb.base_table()[:4].T.copy())
    neg = comb.negate_rows(rows)
    want = np.asarray(jcomb.negate_rows(jnp.asarray(rows.numpy())))
    np.testing.assert_array_equal(neg.numpy(), want)


def test_ladder_mode_and_bad_configs_raise():
    """The ladder mode is ported: it builds, and like JAX's it raises on a
    window other than 4 (a fused-mode knob)."""
    assert gv.GpuVerifier(device="cpu", mode="ladder").config == "ladder"
    with pytest.raises(ValueError, match="fused-mode knob"):
        gv.GpuVerifier(device="cpu", mode="ladder", window=5)
    with pytest.raises(ValueError, match="fused-mode knob"):
        gv.GpuVerifier(device="cpu", mode="comb", window=5)
    with pytest.raises(ValueError):
        gv.GpuVerifier(device="cpu", mode="fused", window=7)
    with pytest.raises(ValueError):
        gv.KeyBank(device="cpu", mode="comb", window=5)


# the JAX bank's caps: about 2 GiB of fused tables, 1,024 comb keys
CAPS = {("fused", 4, "dense"): 512, ("fused", 5, "dense"): 157, ("fused", 6, "dense"): 47,
        ("fused", 4, "packed"): 1024, ("fused", 5, "packed"): 315,
        ("fused", 6, "packed"): 95, ("comb", 4, "dense"): 1024, ("comb", 4, "packed"): 1024}


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("mode,wbits", CONFIGS)
def test_max_keys_equals_the_jax_banks(mode, wbits, name):
    """The bank's default cap is the JAX bank's in every mode, window and
    row layout, under each package's row-packing switch, and does not
    depend on the device's memory."""
    with layout(name):
        bank = gv.KeyBank(initial_capacity=1, device="cpu", mode=mode, window=wbits)
        jbank = jtv.KeyBank(initial_capacity=1, mode=mode, window=wbits)
        assert bank._rows_per_key == jbank._rows_per_key and bank.row == comb.ROW
        assert bank._max_keys == jbank._max_keys == CAPS[mode, wbits, name]


# -- the plain accumulators against JAX's -------------------------------------


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


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("wbits", [5, 6])
def test_plain_accumulate_limb_identical_to_jax(points, wbits, name):
    """madd_loop_plain (the CPU route of fused_accumulate) equals JAX's
    fused_accumulate (accum="xla") limb for limb; its splits over P
    parts, P not dividing 52 or 43, are the same affine points."""
    batch = 8
    with layout(name):
        flat = np.concatenate([comb.fused_table_np(p, wbits) for p in points])
        s, k, base = _fused_inputs(wbits, batch, 50 + wbits, flat.shape[0] // 2)
        want = np.asarray(jcomb.fused_accumulate(
            jnp.asarray(s), jnp.asarray(k), jnp.asarray(base), jnp.asarray(flat),
            window=1 << wbits, accum="xla",
        )).reshape(4, fe.NLIMB, batch)
        got = comb.fused_accumulate(torch.from_numpy(s), torch.from_numpy(k),
                                    torch.from_numpy(base), torch.from_numpy(flat),
                                    window=1 << wbits)
        np.testing.assert_array_equal(got.numpy(), want)
        idx = comb.accumulate_index(torch.from_numpy(s), torch.from_numpy(k),
                                    torch.from_numpy(base), 1 << wbits)
        for parts in (2, 4, 8, 16):
            split = comb.madd_loop_plain(idx, torch.from_numpy(flat), parts=parts).numpy()
            for lane in range(batch):
                assert _affine(split, lane) == _affine(want, lane), (parts, lane)


def test_split_bounds_cover_every_position():
    for npos in (64, 52, 43):
        for parts in (1, 2, 4, 8, 16):
            bounds = comb.split_bounds(npos, parts)
            assert bounds[0][0] == 0 and bounds[-1][1] == npos
            assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
            sizes = {hi - lo for lo, hi in bounds}
            assert max(sizes) - min(sizes) <= 1


# -- verdict bitmaps -----------------------------------------------------------


# the seven configurations: fused w = 4, 5, 6 in both layouts, and comb
# (dense only: packed raises, test_negate_rows_raises_runtime_error_...)
SEVEN = [(m, w, n) for m, w in CONFIGS for n in LAYOUTS if (m, n) != ("comb", "packed")]


@pytest.mark.parametrize("mode,wbits,name", SEVEN)
def test_gpu_verifier_matches_oracle(mode, wbits, name):
    """GpuVerifier(mode, window) on the CPU: every configuration's bitmap
    equals the RFC 8032 oracle's, padding and corrupted rows included."""
    items = _items(b"cfg", n=7)
    with layout(name):
        v = gv.GpuVerifier(device="cpu", mode=mode, window=wbits)
        got = v.verify_batch(items)
        assert v.config == comb.config_name(mode, wbits, comb.ROW)
        assert v.shape_snapshot()["config"] == v.config
    assert got == _oracle(items) == [True, False, False, True, False, True, True]
