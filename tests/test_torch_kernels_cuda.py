"""The CUDA kernels against their plain versions, on a card. Without one
every test here skips.

This file imports neither `jax` nor the JAX package, so on a machine with
a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

- the accumulate kernel in wire mode, with the P its wrapper picks, equals
  `madd_loop_plain(wire_index_plain(...), parts=P)` in every canonical
  limb;
- the verdict kernel equals `encode_and_compare_plain`: the same bitmap
  and the same canonical affine (x, y);
- in every configuration of the accumulate kernel (fused windows of 4, 5
  and 6 bits in dense and packed rows, in wire and index mode, and the
  comb mode), the kernel equals its plain version with the same P;
- the verdict kernel's comb entry (R as staged limbs and sign) equals
  `encode_and_compare_plain`, and both entries do at batch sizes that
  leave a partial group of 5 threads, a partial warp and a partial block;
- the cooperative field ops (multiply, square, inversion at 5 threads an
  element) equal `ops/field25519.py` at 1, 7, 8 and 513 elements;
- the ladder kernel K9 equals `verify_kernel_plain`: the same verdicts and
  the same canonical affine accumulators, on signed items with
  corruptions and the smoke's adversarial rows, at batch sizes on both
  sides of its group, warp and block edges; its point operations (the
  doubling, the cached addition and the decompression, 5 threads a
  point) equal ops/edwards.py;
- the quorum tally kernel, added into a nonzero `out` and into a fresh
  one, equals `quorum_tally_plain` on one-hot rows with padding and on
  random int32 weights that wrap, at B = 1 to 8,193 and up to 1,000
  instances, on its 16-byte path (n_inst % 4 == 0, aligned base) and its
  scalar path (any n_inst, or a base 4 bytes off); both quorum steps on
  Mesh(["cuda:0"] * 4) equal the same steps on Mesh(["cpu"] * 4), with
  four launches of each kernel;
- the replica-unit bench with the gpu verifier makes device passes of
  both kernels in plain and qc mode;
- a pile of 2 x 8,192 + 1 items splits into three chunks of the top
  bucket, in order, with the oracle's bitmap.
"""

import numpy as np
import pytest
import torch

from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
from simple_pbft_tpu_torch.ops import comb
from simple_pbft_tpu_torch.ops import field25519 as fe
from simple_pbft_tpu_torch.ops import ladder


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    pts = [ref.point_decompress(ref.public_key(bytes([i + 1]) * 32)) for i in range(3)]
    flat = np.concatenate([comb.fused_table_np(p, 4) for p in pts])
    return dev, torch.from_numpy(flat).to(dev)


def _wire(dev, batch: int, seed: int):
    rng = np.random.default_rng(seed)
    wire = rng.integers(0, 256, (batch, 96), dtype=np.uint8)
    wire[0, :64], wire[1, :64], wire[2, :64] = 0x00, 0xFF, 0x80
    a_idx = rng.integers(0, 3, batch).astype(np.int32)
    pre = rng.random(batch) < 0.9
    return (torch.from_numpy(wire).to(dev), torch.from_numpy(a_idx).to(dev),
            torch.from_numpy(pre).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 1000])
def test_accumulate_kernel_wire_mode_equals_plain(card, batch):
    dev, f_flat = card
    wire, a_idx, _ = _wire(dev, batch, batch)
    parts = comb.accumulate_kernel.parts_for(batch, dev)
    before = comb.accumulate_kernel.launches
    got = comb.accumulate_kernel.wire(wire, a_idx, f_flat)
    torch.cuda.synchronize()
    assert comb.accumulate_kernel.launches == before + 1
    want = comb.madd_loop_plain(comb.wire_index_plain(wire, a_idx), f_flat, parts=parts)
    want = fe.to_canonical(want.transpose(0, 1)).transpose(0, 1)
    assert torch.equal(got.reshape(4, fe.NLIMB, batch), want)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 1000])
def test_verdict_kernel_equals_plain(card, batch):
    dev, f_flat = card
    wire, a_idx, pre = _wire(dev, batch, batch + 1)
    acc = comb.accumulate_kernel.wire(wire, a_idx, f_flat)
    p = acc.reshape(4, fe.NLIMB, batch)

    def plain():
        return comb.encode_and_compare_plain(p, *comb.r_from_wire(wire), pre, affine=True)

    # give lanes 3 and 4 R = the encoding of their own point, so they match
    _, xy = plain()
    xy = xy.cpu().numpy()
    for lane in (3, 4):
        x = fe._limbs_to_int_np(xy[: fe.NLIMB, lane : lane + 1])
        y = fe._limbs_to_int_np(xy[fe.NLIMB :, lane : lane + 1])
        enc = (y | (x & 1) << 255).to_bytes(32, "little")
        wire[lane, 64:] = torch.tensor(list(enc), dtype=torch.uint8, device=dev)
        pre[lane] = True
    want_ok, want_xy = plain()
    before = comb.encode_kernel.launches
    ok, got_xy = comb.encode_kernel(acc, wire, pre, affine=True)
    torch.cuda.synchronize()
    assert comb.encode_kernel.launches == before + 1
    assert want_ok[3] and want_ok[4]
    assert torch.equal(ok, want_ok)
    assert torch.equal(got_xy, want_xy)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _canonical(p):
    return fe.to_canonical(p.transpose(0, 1)).transpose(0, 1)


CONFIGS = [("fused", w, name) for w in (4, 5, 6) for name in ("dense", "packed")]
CONFIGS.append(("comb", 4, "dense"))


def _comb_inputs(dev, batch, seed):
    """Two keys' comb tables, the base table, nibbles and key row bases."""
    rng = np.random.default_rng(seed)
    pts = [ref.point_decompress(ref.public_key(bytes([i + 1]) * 32)) for i in range(2)]
    a_flat = torch.from_numpy(np.concatenate([comb.comb_table_np(p) for p in pts])).to(dev)
    s = rng.integers(0, 16, (comb.NPOS, batch), dtype=np.int32)
    k = rng.integers(0, 16, (comb.NPOS, batch), dtype=np.int32)
    base = (rng.integers(0, 2, batch) * comb.NPOS * comb.WINDOW).astype(np.int32)
    return ([torch.from_numpy(x).to(dev) for x in (s, k, base)] + [a_flat]
            + [comb.base_table_device(dev)])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 1000])
@pytest.mark.parametrize("mode,wbits,name", CONFIGS)
def test_accumulate_kernel_every_configuration_equals_plain(mode, wbits, name, batch):
    """Every configuration launches K1 and equals its plain version, with
    the P its wrapper picks (P need not divide 52 or 43), in every
    canonical limb."""
    dev = _need_card()
    comb.use_row_packing(name == "packed")
    try:
        k1 = comb.accumulate_kernel
        before = dict(k1.launches_by)
        config = comb.config_name(mode, wbits, comb.ROW)
        if mode == "comb":
            args = _comb_inputs(dev, batch, batch + wbits)
            parts = k1.parts_for(batch, dev)
            got = k1.comb(*args)
            want = comb.comb_accumulate_plain(*args, parts=parts)
            launched = 1
        else:
            pts = [ref.point_decompress(ref.public_key(bytes([i + 1]) * 32)) for i in range(2)]
            f_flat = torch.from_numpy(
                np.concatenate([comb.fused_table_np(p, wbits) for p in pts])).to(dev)
            wire, a_idx, _ = _wire(dev, batch, batch + wbits)
            a_idx = a_idx % 2
            parts = k1.parts_for(batch, dev, comb.npos_for(wbits))
            got = k1.wire(wire, a_idx, f_flat, window=1 << wbits)
            idx = comb.wire_index_plain(wire, a_idx, 1 << wbits)
            want = comb.madd_loop_plain(idx, f_flat, parts=parts)
            got_index = k1(idx.contiguous(), f_flat)
            torch.cuda.synchronize()
            assert torch.equal(got_index.reshape(4, fe.NLIMB, batch), _canonical(want))
            launched = 2
        torch.cuda.synchronize()
        assert k1.launches_by.get(config, 0) == before.get(config, 0) + launched
        assert torch.equal(got.reshape(4, fe.NLIMB, batch), _canonical(want))
    finally:
        comb.use_row_packing(False)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 1000])
def test_verdict_kernel_comb_entry_equals_plain(batch):
    """The limb entry: R.y as (17, B) limbs and its sign as (B,) int32."""
    dev = _need_card()
    args = _comb_inputs(dev, batch, batch)
    acc = comb.accumulate_kernel.comb(*args)
    p = acc.reshape(4, fe.NLIMB, batch)
    rng = np.random.default_rng(batch)
    r_y = torch.from_numpy(rng.integers(0, 1 << 15, (fe.NLIMB, batch), dtype=np.int32)).to(dev)
    r_sign = torch.from_numpy(rng.integers(0, 2, batch).astype(np.int32)).to(dev)
    pre = torch.from_numpy(rng.random(batch) < 0.9).to(dev)
    # lanes 3 and 4 carry their own point's encoding, so they match
    _, xy = comb.encode_and_compare_plain(p, r_y, r_sign, pre, affine=True)
    for lane in (3, 4):
        r_y[:, lane] = xy[fe.NLIMB:, lane]
        r_sign[lane] = xy[0, lane] & 1
        pre[lane] = True
    want_ok, want_xy = comb.encode_and_compare_plain(p, r_y, r_sign, pre, affine=True)
    before = comb.encode_kernel.launches_by.get("limbs", 0)
    ok, got_xy = comb.encode_kernel.limbs(acc, r_y, r_sign, pre, affine=True)
    torch.cuda.synchronize()
    assert comb.encode_kernel.launches_by["limbs"] == before + 1
    assert want_ok[3] and want_ok[4]
    assert torch.equal(ok, want_ok)
    assert torch.equal(got_xy, want_xy)



@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7, 8, 513])
@pytest.mark.parametrize("op", ["coop_mul", "coop_sq", "coop_invert", "coop_pow22523"])
def test_coop_field_ops_equal_plain_field(op, batch):
    """The group's arithmetic (csrc/field25519_coop.cuh, 5 threads an
    element, 6 elements a warp, 24 a block) equals ops/field25519.py in
    canonical limbs, at counts that leave a partial group and a partial
    block; the first lanes hold edge values."""
    dev = _need_card()
    rng = np.random.default_rng(batch)
    vals = [0, 1, fe.P_INT - 1, fe.P_INT, fe.P_INT + 1, 2**255 - 1, 2**255 - 20][:batch]
    vals += [int.from_bytes(bytes(r), "little") % 2**255
             for r in rng.integers(0, 256, (batch - len(vals), 32), dtype=np.uint8)]
    a = torch.from_numpy(np.stack([fe._int_to_limbs_np(v) for v in vals], axis=1)).to(dev)
    a = a.contiguous()
    b = a.flip(1).contiguous()
    want = fe.to_canonical({"coop_mul": lambda: fe.mul(a, b), "coop_sq": lambda: fe.mul(a, a),
                            "coop_invert": lambda: fe.invert(a),
                            "coop_pow22523": lambda: fe.pow22523(a)}[op]())
    got = comb.encode_kernel.field_op(op, a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7, 25, 8193])
@pytest.mark.parametrize("entry", ["wire", "limbs"])
def test_verdict_kernel_partial_groups_equal_plain(entry, batch):
    """Both entries at batch sizes that leave a partial group, warp and
    block: the lanes past the batch run the chain on a filler and store
    nothing; every lane of the batch equals encode_and_compare_plain."""
    dev = _need_card()
    rng = np.random.default_rng(batch + 3)
    acc = rng.integers(0, 1 << 15, (4 * fe.NLIMB, batch), dtype=np.int32)
    acc = torch.from_numpy(acc).to(dev)
    p = acc.reshape(4, fe.NLIMB, batch)
    r_y = torch.from_numpy(rng.integers(0, 1 << 15, (fe.NLIMB, batch), dtype=np.int32)).to(dev)
    r_sign = torch.from_numpy(rng.integers(0, 2, batch).astype(np.int32)).to(dev)
    pre = torch.ones(batch, dtype=torch.bool, device=dev)
    _, xy = comb.encode_and_compare_plain(p, r_y, r_sign, pre, affine=True)
    r_y[:, 0::2] = xy[fe.NLIMB:, 0::2]
    r_sign[0::2] = xy[0, 0::2] & 1
    want_ok, want_xy = comb.encode_and_compare_plain(p, r_y, r_sign, pre, affine=True)
    if entry == "wire":
        wire = rng.integers(0, 256, (batch, 96), dtype=np.uint8)
        r_y_np = r_y.cpu().numpy()
        for lane in range(batch):
            enc = fe._limbs_to_int_np(r_y_np[:, lane:lane + 1]) | int(r_sign[lane]) << 255
            wire[lane, 64:] = np.frombuffer(enc.to_bytes(32, "little"), np.uint8)
        ok, got_xy = comb.encode_kernel(acc, torch.from_numpy(wire).to(dev), pre, affine=True)
    else:
        ok, got_xy = comb.encode_kernel.limbs(acc, r_y, r_sign, pre, affine=True)
    torch.cuda.synchronize()
    assert bool(want_ok[0::2].all())
    assert torch.equal(ok, want_ok)
    assert torch.equal(got_xy, want_xy)


def _ladder_items(batch: int):
    """The adversarial rows of crypto/adversarial.py, then items of 8 signers with
    every third one corrupted (a flipped S or R byte, another message);
    past 512 signed items they repeat."""
    from simple_pbft_tpu_torch.crypto.adversarial import ladder_adversarial_items
    from simple_pbft_tpu_torch.crypto.verifier import BatchItem

    items = [it for _, it in ladder_adversarial_items()][:batch]
    adversarial = len(items)
    seeds = [bytes([i + 1]) * 32 for i in range(8)]
    j = 0
    while len(items) < batch and j < 512:
        seed, msg = seeds[j % 8], b"ladder %d" % j
        sig = bytearray(ref.sign(seed, msg))
        if j % 3 == 1:
            sig[j % 64] ^= 1 << (j % 8)
        if j % 3 == 2:
            msg += b"!"
        items.append(BatchItem(ref.public_key(seed), msg, bytes(sig)))
        j += 1
    signed = items[adversarial:]
    while len(items) < batch:
        items.append(signed[(len(items) - adversarial) % len(signed)])
    return items


# the group, warp and block edges of K9 (5 threads a lane, 6 lanes a warp,
# 24 a block), the adversarial batch (8) and a larger one
LADDER_BATCHES = [1, 5, 6, 7, 8, 24, 25, 512, 8193]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", LADDER_BATCHES)
def test_ladder_kernel_equals_plain(batch):
    """K9 against verify_kernel_plain, exactly: verdicts and canonical
    affine (x, y) of [S]B + [k](-A); one counted launch. Lanes past the
    batch run the chain and store nothing."""
    from simple_pbft_tpu_torch.crypto import gpu_verifier as gv

    dev = _need_card()
    items = _ladder_items(batch)
    arrays = [torch.from_numpy(a).to(dev) for a in gv.prepare_batch(items).arrays()]
    before = ladder.ladder_kernel.launches_by.get("ladder_verify", 0)
    ok, xy = ladder.ladder_kernel(*arrays, affine=True)
    torch.cuda.synchronize()
    assert ladder.ladder_kernel.launches_by["ladder_verify"] == before + 1
    want_ok, want_xy = gv.verify_kernel_plain(*arrays, affine=True)
    assert torch.equal(ok, want_ok)
    assert torch.equal(xy, want_xy)
    oracle = {}  # items repeat past 520: verify each distinct one once
    for i in items:
        if id(i) not in oracle:
            oracle[id(i)] = ref.verify(i.pubkey, i.msg, i.sig)
    assert ok.cpu().tolist() == [oracle[id(i)] for i in items]


def _point_rows(dev, n: int, seed: int):
    """(4·17, n) points: multiples of B with Z != 1, then random elements
    in every coordinate; and (n,) signs."""
    rng = np.random.default_rng(seed)
    cols = []
    for i in range(n):
        if i % 2 == 0:
            z = int(rng.integers(2, 1 << 62))
            pt = [c * z % fe.P_INT for c in ref.point_mul(i + 2, ref.B)]
        else:
            pt = [int.from_bytes(bytes(r), "little") % 2**255
                  for r in rng.integers(0, 256, (4, 32), dtype=np.uint8)]
        cols.append(np.concatenate([fe._int_to_limbs_np(c) for c in pt]))
    p = torch.from_numpy(np.stack(cols, axis=1).astype(np.int32)).to(dev).contiguous()
    sign = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(dev)
    return p, sign


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7, 25, 513])
@pytest.mark.parametrize("op", ["double", "add", "decompress"])
def test_coop_point_ops_equal_plain(op, batch):
    """K9's point operations on the card (a group of 5 threads a point)
    against ops/edwards.py in canonical limbs: the doubling, the addition
    of a cached addend and the decompression with its ok flags."""
    from simple_pbft_tpu_torch.ops import edwards as ed

    dev = _need_card()
    p, sign = _point_rows(dev, batch, batch)
    q, _ = _point_rows(dev, batch, batch + 1)
    got, ok = ladder.ladder_kernel.point_op(op, p, q, sign)
    torch.cuda.synchronize()
    pt, qt = p.reshape(4, fe.NLIMB, batch), q.reshape(4, fe.NLIMB, batch)
    if op == "decompress":
        want, want_ok = ed.decompress(pt[1], sign)
        assert torch.equal(ok, want_ok)
    else:
        want = ed.point_double(pt) if op == "double" else ed.point_add(pt, qt)
        assert bool(ok.all())
    assert torch.equal(got.reshape(4, fe.NLIMB, batch), _canonical(want))


# the tally's shapes: B from one row to a partial warp's ballot, a partial
# row block, the mesh shards' and the whole batch's and one row past it;
# n_inst from one column to the 16-byte path's (4, 128) and past a column
# block (130, 1,000: the scalar path's 5 and 32 column blocks)
TALLY_BATCHES = [1, 7, 8, 33, 512, 8192, 8193]
TALLY_INSTANCES = [1, 3, 4, 128, 130, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("base", ["aligned", "offset"])
@pytest.mark.parametrize("n_inst", TALLY_INSTANCES)
@pytest.mark.parametrize("batch", TALLY_BATCHES)
def test_quorum_tally_kernel_equals_plain(batch, n_inst, base):
    """The tally kernel against quorum_tally_plain, exactly: one-hot rows
    with all-zero padding rows, then random int32 weights whose sums wrap
    modulo 2^32 as JAX's int32 sum does; each added into a nonzero `out`
    and into a fresh zeroed vector. An aligned base with n_inst % 4 == 0
    takes the 16-byte loads; a base 4 bytes off, or another n_inst, the
    scalar path. One counted launch a call."""
    from simple_pbft_tpu_torch.ops import quorum

    dev = _need_card()
    rng = np.random.default_rng(batch * 10 + n_inst)
    onehot = np.eye(n_inst, dtype=np.int32)[rng.integers(0, n_inst, batch)]
    onehot[::5] = 0
    weights = rng.integers(-2**31, 2**31, (batch, n_inst), dtype=np.int64).astype(np.int32)
    verdict = torch.from_numpy(rng.random(batch) < 0.8).to(dev)
    start = rng.integers(-2**31, 2**31, n_inst, dtype=np.int64).astype(np.int32)
    for rows in (onehot, weights):
        skip = 0 if base == "aligned" else 1
        buf = torch.empty(batch * n_inst + skip, dtype=torch.int32, device=dev)
        t = buf[skip:].view(batch, n_inst)
        t.copy_(torch.from_numpy(rows))
        assert quorum.vector_path(t) == (base == "aligned" and n_inst % 4 == 0)
        want = quorum.quorum_tally_plain(t, verdict)
        out = torch.from_numpy(start).to(dev)
        before = quorum.tally_kernel.launches_by.get("quorum_tally", 0)
        assert quorum.tally_kernel(t, verdict, out=out) is out
        fresh = quorum.tally_kernel(t, verdict)
        torch.cuda.synchronize()
        assert quorum.tally_kernel.launches_by["quorum_tally"] == before + 2
        assert torch.equal(fresh, want)
        assert torch.equal(out, (torch.from_numpy(start).long().to(dev) + want.long())
                           .to(torch.int32))


def _vote_items(n: int):
    """n votes of 8 keys over 2 instances, vote 0 corrupted."""
    items = [_signed(i % 8, b"inst vote %d" % i) for i in range(n)]
    broken = bytearray(items[0].sig)
    broken[3] ^= 1
    items[0] = type(items[0])(items[0].pubkey, items[0].msg, bytes(broken))
    return items


def _signed(i: int, msg: bytes):
    from simple_pbft_tpu_torch.crypto.verifier import BatchItem

    seed = bytes([i + 1]) * 32
    return BatchItem(ref.public_key(seed), msg, ref.sign(seed, msg))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["comb", "ladder"])
def test_quorum_steps_on_a_mesh_of_four_on_one_card(kind):
    """Both quorum steps on Mesh(["cuda:0"] * 4) against the same steps on
    Mesh(["cpu"] * 4) (the plain versions): the same verdicts and counts;
    four launches of each of the step's kernels."""
    from simple_pbft_tpu_torch.crypto import gpu_verifier as gv
    from simple_pbft_tpu_torch.ops import quorum
    from simple_pbft_tpu_torch.parallel import Mesh, make_comb_quorum_step, make_quorum_step
    from simple_pbft_tpu_torch.parallel.mesh import gather

    _need_card()
    items = _vote_items(64)
    onehot = np.eye(2, dtype=np.int32)[np.arange(64) % 2]
    if kind == "comb":
        bank = gv.KeyBank(device="cpu", mode="comb")
        prep, _ = gv.prepare_comb_batch(items, bank)
        s, k, a_idx, r_y, r_sign, pre = prep.arrays()
        tables = bank.device_tables()

        def run(mesh):
            return make_comb_quorum_step(mesh)(s, k, a_idx, tables.to(mesh.devices[0]),
                                               comb.base_table_device(mesh.devices[0]),
                                               r_y, r_sign, pre, onehot)
    else:
        arrays = gv.prepare_batch(items).arrays()

        def run(mesh):
            return make_quorum_step(mesh)(*arrays, onehot)

    kernels = (comb.accumulate_kernel, comb.encode_kernel, ladder.ladder_kernel,
               quorum.tally_kernel)
    before = [k.launches for k in kernels]
    verdict, counts = run(Mesh(["cuda:0"] * 4))
    torch.cuda.synchronize()
    launched = [k.launches - b for k, b in zip(kernels, before)]
    assert launched == ([4, 4, 0, 4] if kind == "comb" else [0, 0, 4, 4])
    want_verdict, want_counts = run(Mesh(["cpu"] * 4))
    assert np.array_equal(gather(verdict), gather(want_verdict))
    assert not gather(verdict)[0] and gather(verdict)[1:].all()
    assert [c.cpu().tolist() for c in counts] == [want_counts[0].tolist()] * 4 == [[31, 32]] * 4


@pytest.mark.cuda
def test_mesh_across_cards_equals_the_oracle():
    """On a host with several cards, a mesh of distinct cards (the largest
    power of two of them): both quorum steps and the meshed fused and comb
    verifiers equal the oracle, each shard's verdicts stay on its card,
    and the bank's copies on the other cards follow the bank when it
    grows."""
    from simple_pbft_tpu_torch.crypto import gpu_verifier as gv
    from simple_pbft_tpu_torch.parallel import Mesh, make_comb_quorum_step, make_quorum_step
    from simple_pbft_tpu_torch.parallel.mesh import gather

    _need_card()
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more CUDA devices")
    mesh = Mesh([f"cuda:{i}" for i in range(1 << (cards.bit_length() - 1))])
    items = _vote_items(64)
    oracle = [ref.verify(i.pubkey, i.msg, i.sig) for i in items]
    onehot = np.eye(2, dtype=np.int32)[np.arange(64) % 2]
    want_counts = [sum(oracle[0::2]), sum(oracle[1::2])]

    bank = gv.KeyBank(device=mesh.devices[0], mode="comb")
    s, k, a_idx, r_y, r_sign, pre = gv.prepare_comb_batch(items, bank)[0].arrays()
    steps = {
        "comb": make_comb_quorum_step(mesh)(s, k, a_idx, bank.device_tables(),
                                            comb.base_table_device(mesh.devices[0]),
                                            r_y, r_sign, pre, onehot),
        "ladder": make_quorum_step(mesh)(*gv.prepare_batch(items).arrays(), onehot),
    }
    for kind, (verdict, counts) in steps.items():
        assert [v.device for v in verdict] == list(mesh.devices), kind
        assert gather(verdict).tolist() == oracle, kind
        assert [c.device for c in counts] == list(mesh.devices), kind
        assert [c.cpu().tolist() for c in counts] == [want_counts] * mesh.size, kind

    for mode in ("fused", "comb"):
        v = gv.GpuVerifier(mode=mode, mesh=mesh)
        assert v.verify_batch(items) == oracle, mode
        assert set(v._bank._replicas) == set(mesh.devices[1:]), mode
        # a new key grows the bank past its 8 slots: every card's copy is
        # dropped with the upload and made again from the grown bank
        more = [_signed(8 + i, b"late key %d" % i) for i in range(4)] + items[:4]
        assert v.verify_batch(more) == [True] * 4 + oracle[:4], mode
        for d in mesh.devices[1:]:
            assert torch.equal(v._bank.device_tables(d).cpu(), v._bank.device_tables().cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "qc"])
def test_replica_unit_verifies_on_the_card(card, mode, monkeypatch):
    """The replica-unit bench with --verifier gpu at n = 16, 4 blocks of
    128: the first sweep's 604 signatures are over the verify service's
    starting CPU cutoff (375), so they make a device pass of both kernels."""
    import asyncio

    from simple_pbft_tpu_torch import bench_replica_unit

    monkeypatch.setenv("RU_MAX_SWEEP", "1024")
    rec = asyncio.run(bench_replica_unit.run_mode(mode, 16, 4, 128, verifier="gpu"))
    assert rec["ok"] and rec["completed_blocks"] == 4 and rec["platform"] == "gpu"
    assert rec["svc_device_passes"] > 0, rec
    assert rec["kernel_launches"]["fused_accumulate"] > 0, rec
    assert rec["kernel_launches"]["encode_verdict"] > 0, rec
    assert rec["bank_keys"] == 16 + bench_replica_unit.N_CLIENTS


@pytest.mark.cuda
def test_pile_over_the_top_bucket_splits_into_chunks_on_the_card(card):
    """2 x 8,192 + 1 items, the largest pile a NEW-VIEW storm can send in
    one submission: GpuVerifier.dispatch_batch splits it into three chunks
    of the top bucket, in order, one launch of each kernel a chunk, and
    the bitmap is the oracle's, with bad signatures on both sides of each
    chunk edge."""
    from simple_pbft_tpu_torch.crypto.gpu_verifier import BUCKETS, GpuVerifier
    from simple_pbft_tpu_torch.crypto.verifier import BatchItem, kernel_equivalent_cpu_verifier

    top = BUCKETS[-1]
    signed = [_signed(i % 16, b"storm pile %d" % i) for i in range(1024)]
    items = (signed * (2 * top // len(signed) + 1))[: 2 * top + 1]
    bad = (top - 1, top, 2 * top - 1, 2 * top)
    for p in bad:
        sig = bytearray(items[p].sig)
        sig[40] ^= 0x10
        items[p] = BatchItem(items[p].pubkey, items[p].msg, bytes(sig))
    oracle = kernel_equivalent_cpu_verifier().verify_batch(items)
    assert [i for i, ok in enumerate(oracle) if not ok] == list(bad)
    v = GpuVerifier(initial_keys=16)
    v.warm_for_population([it.pubkey for it in signed[:16]], max_sweep=top)
    assert v.verify_batch(items) == oracle
    tally = v.launch_tally()
    assert tally["chunks"] == 3 and tally["chunked_dispatches"] == 1
    assert tally["max_dispatch_items"] == 2 * top + 1 and v.post_warm_compiles == 0
    assert tally["launches"] == {"fused_accumulate": 3, "encode_verdict": 3, "ladder_verify": 0}
