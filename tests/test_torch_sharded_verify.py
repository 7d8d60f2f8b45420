"""The port's multi-device path on the CPU against the JAX package's.

`parallel/` of the port runs a mesh of torch devices in one process; here
``Mesh(["cpu"] * k)`` stands beside JAX's 8 virtual CPU devices
(tests/conftest.py). The same seeded inputs go through both packages:

- the quorum tally's plain version against the JAX expression;
- the comb and ladder quorum steps (verdicts and the psum'd counts);
- GpuVerifier(mesh=...) in fused dense and packed, comb and ladder modes
  on meshes of 2 and 8, against the RFC 8032 oracle and the JAX
  TpuVerifier(mesh=...) of the same mode on its 8 devices;
- instrument_step's per-device ledger rows, the dry run, and a committee
  over a meshed verifier.

Every comparison is exact: bitmaps and integer counts.
"""

import asyncio
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from simple_pbft_tpu.crypto import tpu_verifier as jtv
from simple_pbft_tpu.ops import comb as jcomb
from simple_pbft_tpu.parallel import make_comb_quorum_step as jax_comb_step
from simple_pbft_tpu.parallel import make_quorum_step as jax_ladder_step
from simple_pbft_tpu_torch import devledger
from simple_pbft_tpu_torch.committee import LocalCommittee
from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
from simple_pbft_tpu_torch.crypto.gpu_verifier import GpuVerifier, KeyBank
from simple_pbft_tpu_torch.crypto.verifier import BatchItem
from simple_pbft_tpu_torch.ops import comb
from simple_pbft_tpu_torch.ops.quorum import quorum_tally, quorum_tally_plain, tally_kernel
from simple_pbft_tpu_torch.parallel import Mesh, make_comb_quorum_step, make_quorum_step
from simple_pbft_tpu_torch.parallel.dryrun import dryrun_multichip
from simple_pbft_tpu_torch.parallel.mesh import P, gather, psum, shard, shard_map
from simple_pbft_tpu_torch.parallel.sharded_verify import instrument_step

N_INST = 2


def _signed(i: int, msg: bytes):
    seed = bytes([i]) * 32
    return BatchItem(ref.public_key(seed), msg, ref.sign(seed, msg))


def _onehot(batch: int, n_inst: int, rng, pad_every: int = 0) -> np.ndarray:
    """(batch, n_inst) int32 one-hot rows; every pad_every-th row all zero."""
    onehot = np.eye(n_inst, dtype=np.int32)[rng.integers(0, n_inst, batch)]
    if pad_every:
        onehot[::pad_every] = 0
    return onehot


# ---------------------------------------------------------------------------
# the tally
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_inst", [1, 2, 3, 5, 128])
@pytest.mark.parametrize("batch", [8, 32])
def test_quorum_tally_plain_equals_the_jax_expression(batch, n_inst):
    rng = np.random.default_rng(batch * 1000 + n_inst)
    onehot = _onehot(batch, n_inst, rng, pad_every=3)
    verdict = rng.random(batch) < 0.7
    want = np.asarray(jnp.sum(jnp.asarray(onehot) * jnp.asarray(verdict)[:, None]
                              .astype(jnp.int32), axis=0))
    got = quorum_tally(torch.from_numpy(onehot), torch.from_numpy(verdict))
    assert got.dtype == torch.int32 and got.shape == (n_inst,)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(quorum_tally_plain(torch.from_numpy(onehot),
                                             torch.from_numpy(verdict)).numpy(), want)


def _jax_tally(onehot: np.ndarray, verdict: np.ndarray) -> jnp.ndarray:
    return jnp.sum(jnp.asarray(onehot) * jnp.asarray(verdict)[:, None].astype(jnp.int32),
                   axis=0)


@pytest.mark.parametrize("wrap", [False, True], ids=["small", "wraps"])
@pytest.mark.parametrize("n_inst", [3, 5, 128])
@pytest.mark.parametrize("batch", [8, 32])
def test_quorum_tally_out_adds_as_the_jax_sum_of_two_tallies(batch, n_inst, wrap):
    """Two tallies added into one `out` equal JAX's two int32 sums added,
    bit for bit; with every entry a weight near 2^30 the counts wrap past
    2^31 (and past 2^32) as JAX's do."""
    rng = np.random.default_rng(batch * 7 + n_inst + 1000 * wrap)
    shards = []
    for _ in range(2):
        onehot = _onehot(batch, n_inst, rng, pad_every=5)
        if wrap:
            onehot = rng.integers(1 << 29, 1 << 30, (batch, n_inst), dtype=np.int32)
            onehot[::5] = 0
        shards.append((onehot, rng.random(batch) < 0.8))
    want = np.asarray(_jax_tally(*shards[0]) + _jax_tally(*shards[1]))
    out = torch.zeros(n_inst, dtype=torch.int32)
    for onehot, verdict in shards:
        got = quorum_tally(torch.from_numpy(onehot), torch.from_numpy(verdict), out=out)
        assert got is out
    assert out.dtype == torch.int32 and np.array_equal(out.numpy(), want)
    wide = sum((o.astype(np.int64) * v[:, None]).sum(0) for o, v in shards)
    assert (wide > np.iinfo(np.int32).max).any() == wrap


def test_quorum_tally_checks_out():
    onehot = torch.eye(3, dtype=torch.int32)
    verdict = torch.ones(3, dtype=torch.bool)
    with pytest.raises(TypeError):
        quorum_tally(onehot, verdict, out=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        quorum_tally(onehot, verdict, out=torch.zeros(4, dtype=torch.int32))
    out = torch.full((3,), 5, dtype=torch.int32)
    assert quorum_tally(onehot, verdict, out=out).tolist() == [6, 6, 6]


def test_quorum_tally_on_cpu_runs_the_plain_version_and_the_kernel_refuses_it():
    onehot = torch.eye(2, dtype=torch.int32)[torch.tensor([0, 1, 1])]
    verdict = torch.tensor([True, True, False])
    before = tally_kernel.launches
    assert quorum_tally(onehot, verdict).tolist() == [1, 1]
    assert tally_kernel.launches == before
    with pytest.raises(ValueError):
        tally_kernel(onehot, verdict)  # CPU tensors: the kernel raises
    with pytest.raises(ValueError):
        quorum_tally_plain(onehot, verdict[:2])


# ---------------------------------------------------------------------------
# the mesh and its splits
# ---------------------------------------------------------------------------


def test_mesh_splits_by_the_jax_partition_specs():
    mesh = Mesh(["cpu"] * 4)
    assert int(np.prod(mesh.devices.shape)) == 4 and mesh.distinct() == [torch.device("cpu")]
    vec = np.arange(8, dtype=np.int32)
    mat = np.arange(24, dtype=np.int32).reshape(3, 8)
    rows = np.arange(16, dtype=np.uint8).reshape(8, 2)
    assert [s.tolist() for s in shard(vec, P("dp"), mesh)] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    cols = shard(mat, P(None, "dp"), mesh)
    assert all(s.shape == (3, 2) and s.is_contiguous() for s in cols)
    assert np.array_equal(gather(cols, dim=1), mat)
    assert np.array_equal(gather(shard(rows, P("dp", None), mesh)), rows)
    repl = shard(torch.ones(3), P(), mesh)
    assert len(repl) == 4 and all(r is repl[0] for r in repl)  # one copy a device
    with pytest.raises(ValueError, match="does not divide"):
        shard(np.zeros(6), P("dp"), mesh)
    with pytest.raises(ValueError, match="mesh axis"):
        shard(vec, P("mp"), mesh)
    one = torch.tensor([6, 4], dtype=torch.int32)
    summed = psum({torch.device("cpu"): one}, mesh)
    assert len(summed) == 4 and all(s is one for s in summed)  # one device: no add
    two = Mesh(["cpu", "cpu:0"] * 2)
    summed = psum({torch.device("cpu"): one, torch.device("cpu:0"): one + 1}, two)
    assert [s.tolist() for s in summed] == [[13, 9]] * 4
    with pytest.raises(ValueError, match="one partial a distinct device"):
        psum({torch.device("cpu"): one}, two)
    out = shard_map(lambda a, b: a + b, mesh, (P("dp"), P()))(vec, torch.tensor(10))
    assert np.array_equal(gather(out), vec + 10)


def test_bank_copies_on_other_devices_follow_the_bank():
    """A second device's copy of the tables is dropped when the bank
    grows, so no device verifies against an older table."""
    bank = KeyBank(initial_capacity=1, device="cpu", mode="comb")
    other = torch.device("cpu", 0)  # a distinct device object of the same memory
    bank.lookup(ref.public_key(b"\x01" * 32))
    first = bank.device_tables(other)
    assert first is not bank.device_tables() and torch.equal(first, bank.device_tables())
    assert bank.device_tables(other) is first
    bank.lookup(ref.public_key(b"\x02" * 32))  # grows the bank to 2 keys
    grown = bank.device_tables(other)
    assert grown.shape[0] == 2 * first.shape[0]
    assert torch.equal(grown, bank.device_tables())


# ---------------------------------------------------------------------------
# the quorum steps against JAX's on the 8-device mesh
# ---------------------------------------------------------------------------


def _vote_items():
    """tests/test_tpu_verifier.py's 16 votes of 2 instances, vote 0 corrupted."""
    items = [_signed(i % 8, b"inst vote %d" % i) for i in range(16)]
    broken = bytearray(items[0].sig)
    broken[3] ^= 1
    items[0] = BatchItem(items[0].pubkey, items[0].msg, bytes(broken))
    return items


def _meshed_items():
    """12 signed items of 4 keys and one forgery: 13 items, so the batch
    pads (to the bucket of 32) before it splits."""
    items = [_signed(i % 4, b"meshed %d" % i) for i in range(12)]
    items.append(BatchItem(items[0].pubkey, b"not the msg", items[0].sig))
    return items


MESHED = [("fused", False), ("fused", True), ("comb", False), ("ladder", False)]


def _jax_steps(jmesh):
    """The two steps' inputs (staged by the JAX package) and the JAX
    steps' (verdict, counts) on its 8-device mesh."""
    vec = NamedSharding(jmesh, JP("dp"))
    mat = NamedSharding(jmesh, JP(None, "dp"))
    repl = NamedSharding(jmesh, JP())
    onehot_spec = NamedSharding(jmesh, JP("dp", None))
    items = _vote_items()
    onehot = np.eye(N_INST, dtype=np.int32)[np.arange(16) % N_INST]

    ladder_args = [*jtv.prepare_batch(items).arrays(), onehot]
    specs = [mat, vec, mat, vec, mat, mat, vec, onehot_spec]
    out = jax_ladder_step(jmesh)(*[jax.device_put(a, s) for a, s in zip(ladder_args, specs)])
    ladder_want = tuple(np.asarray(o) for o in out)

    bank = jtv.KeyBank()
    prep, _ = jtv.prepare_comb_batch(items, bank)
    s_nib, k_nib, a_idx, r_y, r_sign, precheck = prep.arrays()
    comb_args = [s_nib, k_nib, a_idx, np.asarray(bank.device_tables()), jcomb.base_table(),
                 r_y, r_sign, precheck, onehot]
    specs = [mat, mat, vec, repl, repl, mat, vec, vec, onehot_spec]
    out = jax_comb_step(jmesh)(*[jax.device_put(a, s) for a, s in zip(comb_args, specs)])
    comb_want = tuple(np.asarray(o) for o in out)
    return {"comb": (comb_args, comb_want), "ladder": (ladder_args, ladder_want)}


def _jax_verdicts(jmesh, mode, packed=False):
    """The JAX TpuVerifier(mesh=...)'s bitmap of the 13 meshed items."""
    jcomb.use_row_packing(packed)
    try:
        return jtv.TpuVerifier(mesh=jmesh, mode=mode).verify_batch(_meshed_items())
    finally:
        jcomb.use_row_packing(False)


@pytest.fixture(scope="module")
def jax_ref():
    """Everything the port is held to from the JAX package, on its
    8-device CPU mesh, built once: the two quorum steps (under "comb" and
    "ladder") and TpuVerifier(mesh=...)'s bitmap in each meshed mode
    (under "verifier"). Each program compiles for tens of seconds cold,
    so the steps compile on a second thread while the comb and ladder
    verifiers compile on this one (the verifiers share a process-wide
    device lock, the steps take none); the fused verifiers follow, as
    they toggle the row packing that the steps' tables read."""
    jmesh = JaxMesh(np.asarray(jax.devices()[:8]), ("dp",))
    with ThreadPoolExecutor(1) as pool:
        steps = pool.submit(_jax_steps, jmesh)
        verdicts = {(mode, False): _jax_verdicts(jmesh, mode) for mode in ("ladder", "comb")}
        ref = steps.result()
    for packed in (False, True):
        verdicts["fused", packed] = _jax_verdicts(jmesh, "fused", packed)
    ref["verifier"] = verdicts
    return ref


@pytest.mark.parametrize("kind", ["comb", "ladder"])
def test_quorum_step_equals_the_jax_step_on_8_devices(jax_ref, kind):
    args, (want_verdict, want_counts) = jax_ref[kind]
    mesh = Mesh(["cpu"] * 8)
    make = make_comb_quorum_step if kind == "comb" else make_quorum_step
    verdict, counts = make(mesh)(*args)
    assert len(verdict) == 8 and all(v.shape == (2,) and v.dtype == torch.bool for v in verdict)
    assert np.array_equal(gather(verdict), want_verdict)
    assert not want_verdict[0] and want_verdict[1:].all()
    assert len(counts) == 8  # replicated: one (n_inst,) vector a position
    for c in counts:
        assert c.dtype == torch.int32 and c.tolist() == want_counts.tolist() == [7, 8]


def test_comb_quorum_step_on_meshes_of_1_and_2(jax_ref):
    args, (want_verdict, want_counts) = jax_ref["comb"]
    for k in (1, 2):
        verdict, counts = make_comb_quorum_step(Mesh(["cpu"] * k))(*args)
        assert np.array_equal(gather(verdict), want_verdict)
        assert [c.tolist() for c in counts] == [want_counts.tolist()] * k


@pytest.mark.parametrize("kind", ["comb", "ladder"])
def test_quorum_step_adds_a_devices_shards_into_one_vector(jax_ref, kind, monkeypatch):
    """On a mesh of 4 positions over 2 distinct devices the step zeroes
    one counts vector a device, each shard's tally adds into its device's
    vector, and psum adds the two: the counts equal JAX's on every
    position."""
    from simple_pbft_tpu_torch.parallel import sharded_verify

    args, (want_verdict, want_counts) = jax_ref[kind]
    outs = []

    def tally(onehot, verdict, out=None):
        outs.append(out)
        return quorum_tally(onehot, verdict, out=out)

    monkeypatch.setattr(sharded_verify, "quorum_tally", tally)
    mesh = Mesh(["cpu", "cpu:0"] * 2)
    make = make_comb_quorum_step if kind == "comb" else make_quorum_step
    verdict, counts = make(mesh)(*args)
    assert len(outs) == 4 and outs[0] is outs[2] and outs[1] is outs[3]
    assert outs[0] is not outs[1]
    assert np.array_equal(gather(verdict), want_verdict)
    assert [c.tolist() for c in counts] == [want_counts.tolist()] * 4
    assert counts[0] is counts[2] and counts[1] is counts[3]


def test_quorum_step_rejects_a_batch_that_does_not_divide(jax_ref):
    args, _ = jax_ref["comb"]
    with pytest.raises(ValueError, match="does not divide"):
        make_comb_quorum_step(Mesh(["cpu"] * 3))(*args)
    with pytest.raises(ValueError, match="mesh axis"):
        make_comb_quorum_step(Mesh(["cpu"] * 2), axis="mp")(*args)


# ---------------------------------------------------------------------------
# the meshed verifier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("mode,packed", MESHED,
                         ids=["fused-dense", "fused-packed", "comb", "ladder"])
def test_meshed_verifier_equals_oracle_and_jax(jax_ref, mode, packed, k):
    items = _meshed_items()
    oracle = [ref.verify(i.pubkey, i.msg, i.sig) for i in items]
    assert oracle == [True] * 12 + [False]
    # the JAX TpuVerifier(mesh=...) on its 8-device mesh, in the same mode
    assert jax_ref["verifier"][mode, packed] == oracle
    comb.use_row_packing(packed)
    try:
        mesh = Mesh(["cpu"] * k)
        v = GpuVerifier(device="cpu", mode=mode, mesh=mesh)
        assert v._mesh is mesh and v.device == torch.device("cpu")
        before = v.device_calls
        assert v.verify_batch(items) == oracle
        assert v.device_calls == before + 1 and v.bucket_hits == {32: 1}
    finally:
        comb.use_row_packing(False)


def test_meshed_verifier_pads_to_the_mesh_and_keeps_order():
    """A batch smaller than the mesh pads to it; the shards' verdicts
    join in order, and a fallback row (a key over the bank's cap) is set
    after they do."""
    items = [_signed(i + 1, b"order %d" % i) for i in range(5)]
    items[3] = BatchItem(items[3].pubkey, items[3].msg + b"!", items[3].sig)
    v = GpuVerifier(device="cpu", mode="fused", mesh=Mesh(["cpu"] * 16))
    v._bank._max_keys = 3  # keys 4 and 5 verify on the CPU fallback path
    assert v.verify_batch(items) == [True, True, True, False, True]
    assert v.bucket_hits == {32: 1}  # 5 items -> the mesh's 16 -> bucket 32


def test_mesh_of_three_raises_in_both_packages():
    with pytest.raises(ValueError, match="power-of-two mesh size"):
        GpuVerifier(device="cpu", mesh=Mesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="power-of-two mesh size"):
        jtv.TpuVerifier(mesh=JaxMesh(np.asarray(jax.devices()[:3]), ("dp",)))


# ---------------------------------------------------------------------------
# the ledger, the dry run, a committee
# ---------------------------------------------------------------------------


@pytest.fixture()
def fresh_ledger():
    devledger.configure("t")
    yield devledger.ledger()
    devledger.configure("")


def test_shard_lane_per_device_events(fresh_ledger):
    """instrument_step fans one pass into per-device events
    (tests/test_devledger.py's assertions, on the port's ledger)."""
    mesh = SimpleNamespace(devices=np.zeros(2))  # 2-"device" stand-in
    calls = []

    def step(*args):
        calls.append(args)
        return np.ones(8, dtype=bool)

    run = instrument_step(step, mesh, mode="comb", window=4)
    out = run(np.zeros((17, 8), np.int32), np.zeros(8, np.int32), n_valid=6)
    assert out.shape == (8,) and len(calls) == 1
    evs = [e for e in devledger.recent() if e["lane"] == "shard"]
    assert len(evs) == 2
    assert {e["device"] for e in evs} == {"d0", "d1"}
    assert all(e["bucket"] == 4 for e in evs)
    assert sum(e["n"] for e in evs) == 6  # pre-pad items split across
    lane = devledger.snapshot()["lanes"]["shard"]
    assert lane["devices"] == 2 and lane["dispatches"] == 2
    # one step is one first-time shape, stamped on one device row only
    assert sum(1 for e in evs if e["compile"]) == 1
    assert lane["compiles"] == 1
    # occupancy normalizes by device count: one pass != 2x busy window
    assert lane["occupancy"] <= 1.0


def test_instrument_step_records_a_real_mesh_step(fresh_ledger, jax_ref):
    args, (want_verdict, want_counts) = jax_ref["comb"]
    mesh = Mesh(["cpu"] * 4)
    run = instrument_step(make_comb_quorum_step(mesh), mesh, mode="comb")
    verdict, counts = run(*args, n_valid=15)
    assert np.array_equal(gather(verdict), want_verdict)
    evs = [e for e in devledger.recent() if e["lane"] == "shard"]
    assert [e["device"] for e in evs] == ["d0", "d1", "d2", "d3"]
    assert [e["n"] for e in evs] == [4, 4, 4, 3] and {e["bucket"] for e in evs} == {4}


def test_port_dryrun_multichip_on_8_cpu_positions():
    dryrun_multichip(8, device="cpu")


def test_committee_over_meshed_gpu_verifier():
    """tests/test_committee.py's meshed-verifier committee on the port:
    one GpuVerifier over a mesh of 2 shared by every replica of an n = 4
    committee, the consensus traffic itself reaching the mesh."""

    async def scenario():
        shared = GpuVerifier(device="cpu", mode="fused", initial_keys=16,
                             mesh=Mesh(["cpu"] * 2))
        com = LocalCommittee.build(n=4, clients=1, verifier_factory=lambda: shared,
                                   view_timeout=60.0)
        shared.warm(pubkeys=[kp.pub for kp in com.keys.values()], buckets=[8, 32])
        baseline = shared.device_calls  # warm() already dispatched
        com.clients[0].request_timeout = 50.0
        com.start()
        try:
            assert await com.clients[0].submit("put m1 1") == "ok"
            assert await com.clients[0].submit("get m1") == "1"
            assert shared.device_calls > baseline
        finally:
            await com.stop()

    asyncio.run(asyncio.wait_for(scenario(), 180))
