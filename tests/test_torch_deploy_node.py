"""The port's deployment documents, node verifier and TCP committee on the
CPU, against the JAX package's.

Every device pass here runs the kernels' plain versions on CPU tensors
(``GpuVerifier(device="cpu")``); the services keep to the 8 and 32
buckets.
"""

import asyncio
import os
from unittest import mock

import pytest
import torch

from simple_pbft_tpu import deploy as jdeploy
from simple_pbft_tpu.committee import LocalCommittee as JaxCommittee
from simple_pbft_tpu_torch import deploy as tdeploy
from simple_pbft_tpu_torch.app import KVStore
from simple_pbft_tpu_torch.committee import LocalCommittee
from simple_pbft_tpu_torch.consensus.replica import Replica
from simple_pbft_tpu_torch.client import Client
from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
from simple_pbft_tpu_torch.crypto.coalesce import VerifyService
from simple_pbft_tpu_torch.crypto.gpu_verifier import GpuVerifier
from simple_pbft_tpu_torch.crypto.verifier import BatchItem
from simple_pbft_tpu_torch.node import make_transport, make_verifier


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _base_port(offset):
    # 21000-24490 with the client's +500: apart from the other tests'
    # ranges (7400-11000, and tests/test_torch_launch.py's 30000 up)
    return 21000 + (os.getpid() % 300) * 10 + offset


@pytest.mark.parametrize("writer,reader", [(jdeploy, tdeploy), (tdeploy, jdeploy)],
                         ids=["jax-to-port", "port-to-jax"])
def test_committee_document_loads_across_packages(tmp_path, writer, reader):
    dep = writer.generate(str(tmp_path), n=4, clients=2, base_port=7300,
                          view_timeout=3.0, max_batch=64)
    loaded = reader.load(str(tmp_path / "committee.json"))
    assert loaded.addresses == dep.addresses
    assert loaded.cfg.pubkeys == dep.cfg.pubkeys
    assert loaded.cfg.kx_pubkeys == dep.cfg.kx_pubkeys
    assert loaded.cfg.replica_ids == dep.cfg.replica_ids
    assert (loaded.cfg.n, loaded.cfg.f) == (dep.cfg.n, dep.cfg.f)
    assert (loaded.cfg.view_timeout, loaded.cfg.max_batch) == (3.0, 64)
    for node in ["r0", "r1", "r2", "r3", "c0", "c1"]:
        assert reader.read_seed(str(tmp_path), node) == writer.read_seed(str(tmp_path), node)


def test_node_gpu_verifier_sized_and_warmed_from_deploy(tmp_path):
    """The gpu backend sizes the key bank to the deploy document's key
    population plus 32, registers every published key, and takes a
    walk-in key without growing (a bank growing under live traffic
    re-uploads its tables mid-consensus)."""
    tdeploy.generate(str(tmp_path), n=4, clients=2, base_port=7410)
    dep = tdeploy.load(str(tmp_path / "committee.json"))
    # warm only the smallest bucket: the boot warm runs every bucket up
    # to 8192, which the chip smoke covers
    real_warm = GpuVerifier.warm
    with mock.patch.object(
        GpuVerifier, "warm",
        lambda self, pubkeys=(), buckets=(8,): real_warm(self, pubkeys, (8,)),
    ):
        svc = make_verifier("gpu", dep, device="cpu")
    try:
        v = svc.device
        assert isinstance(v, GpuVerifier) and v.device.type == "cpu"
        n_keys = len(dep.cfg.pubkeys)
        assert len(v._bank._index) == n_keys
        cap = v._bank._cap
        assert cap >= n_keys + 32
        seed = b"\x77" * 32
        walkin = BatchItem(ref.public_key(seed), b"walk-in", ref.sign(seed, b"walk-in"))
        assert v.verify_batch([walkin]) == [True]
        assert len(v._bank._index) == n_keys + 1
        assert v._bank._cap == cap
        assert v.shape_snapshot()["post_warm_compiles"] == 0
    finally:
        svc.close()


def test_node_gpu_verifier_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the gpu node would serve")
    tdeploy.generate(str(tmp_path), n=4, clients=1, base_port=7420)
    dep = tdeploy.load(str(tmp_path / "committee.json"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_verifier("gpu", dep)


PUTS = [f"put k{i} v{i}" for i in range(6)]


def _expected_digest():
    kv = KVStore()
    for op in PUTS:
        kv.apply(op)
    return kv.state_digest()


async def _settle(replicas, want, seconds=10.0):
    """A client may return on speculative replies, before any replica
    has committed the last put: wait until every replica's state holds
    all of PUTS, for at most `seconds`."""
    for _ in range(int(seconds / 0.05)):
        if {r.app.state_digest() for r in replicas} == {want}:
            return
        await asyncio.sleep(0.05)


# The port half's timers. Every device pass here runs the plain versions
# on the CPU, about 0.25 s a pass on an idle 8-core host, and a put waits on
# about five of them (1.2-1.5 s): within reach of the configuration's 2 s
# view timer and the client's 1 s request timer. Under a loaded test run
# (six workers) passes take several times as long, the backups' view
# timers fired, and the run fell into view changes and client retries
# that this test does not examine. So the committee runs with the 30 s
# view timer of chip_smoke.py and bench_consensus.py's clean runs, the
# client waits 5 s an attempt, and the settle wait ends on the expected
# state or after 60 s; the JAX half keeps its defaults (its CPU verifier
# answers in milliseconds).
PORT_VIEW_TIMEOUT = 30.0
PORT_REQUEST_TIMEOUT = 5.0
PORT_SETTLE_S = 60.0


def test_tcp_committee_on_shared_gpu_service_matches_jax(tmp_path):
    """n = 4 replicas and a client in one process over the port's real
    TcpTransport (node.make_transport), all verifying through one
    VerifyService(GpuVerifier(device="cpu")) with the CPU route off."""
    dep = tdeploy.generate(str(tmp_path), n=4, clients=1, base_port=_base_port(0),
                           view_timeout=PORT_VIEW_TIMEOUT)
    assert dep.cfg.view_timeout == PORT_VIEW_TIMEOUT
    gpu = GpuVerifier(device="cpu", initial_keys=len(dep.cfg.pubkeys) + 32)
    svc = VerifyService(gpu, cpu_cutoff=0, max_batch=32, dispatch_deadline=None)
    svc.warm_for_population(list(dep.cfg.pubkeys.values()), max_sweep=32)

    async def scenario():
        transports = {i: make_transport("tcp", i, dep) for i in [*dep.cfg.replica_ids, "c0"]}
        for t in transports.values():
            await t.start()
        replicas = [
            Replica(node_id=rid, cfg=dep.cfg, seed=tdeploy.read_seed(str(tmp_path), rid),
                    transport=transports[rid], app=KVStore(), verifier=svc)
            for rid in dep.cfg.replica_ids
        ]
        client = Client(client_id="c0", cfg=dep.cfg,
                        seed=tdeploy.read_seed(str(tmp_path), "c0"),
                        transport=transports["c0"], request_timeout=PORT_REQUEST_TIMEOUT)
        for r in replicas:
            r.start()
        client.start()
        try:
            replies = [await client.submit(op) for op in PUTS]
            await _settle(replicas, _expected_digest(), PORT_SETTLE_S)
            return (replies, {r.app.state_digest() for r in replicas}, transports,
                    sorted(r.executed_seq for r in replicas), sorted(r.view for r in replicas))
        finally:
            await client.stop()
            for r in replicas:
                await r.stop()
            for t in transports.values():
                await t.stop()

    try:
        replies, digests, transports, executed, views = run(scenario())
    finally:
        svc.close()
    assert replies == ["ok"] * len(PUTS)
    assert svc.device_passes > 0 and svc.cpu_passes == 0
    assert gpu.post_warm_compiles == 0
    assert all(type(t).__name__ == "TcpTransport" for t in transports.values())
    assert digests == {_expected_digest()}, (executed, views)

    jax_com = JaxCommittee.build(n=4, clients=1)

    async def jax_scenario():
        jax_com.start()
        try:
            out = [await jax_com.clients[0].submit(op) for op in PUTS]
            await _settle(jax_com.replicas, _expected_digest())
            return out
        finally:
            await jax_com.stop()

    assert run(jax_scenario()) == replies
    assert {r.app.state_digest() for r in jax_com.replicas} == digests


# -- the JAX package's coalescing tests (tests/test_coalesce.py), with the
# -- port's GpuVerifier(device="cpu") as the device


def _device_service(n_keys=16):
    dev = GpuVerifier(device="cpu", initial_keys=n_keys)
    return dev, VerifyService(dev, cpu_cutoff=0, max_batch=32)


def test_committee_commits_through_real_device_route():
    """Every replica fronts one service over a real GpuVerifier with the
    CPU path disabled, so every sweep is a device pass: replica -> submit
    -> coalesce -> dispatch -> finisher -> future -> quorum -> execute."""

    async def scenario():
        dev, svc = _device_service()
        com = LocalCommittee.build(n=4, clients=1, verifier_factory=lambda: svc, max_batch=8)
        dev.warm_for_population([kp.pub for kp in com.keys.values()], max_sweep=32)
        com.start()
        try:
            res = await asyncio.gather(
                *(com.clients[0].submit(f"put k{i} v{i}") for i in range(6))
            )
            assert res == ["ok"] * 6
        finally:
            await com.stop()
            svc.close()
        assert svc.device_passes > 0 and svc.cpu_passes == 0
        assert len({r.app.state_digest() for r in com.replicas}) == 1

    run(scenario(), timeout=300)


def test_failover_through_coalescing_service():
    """The primary crashes while every replica fronts the SAME service
    over a real device route; the view change, whose certificate
    verifies also ride the service, elects a new primary and commits."""

    async def scenario():
        dev, svc = _device_service()
        com = LocalCommittee.build(
            n=4, clients=1, verifier_factory=lambda: svc, max_batch=8,
            view_timeout=1.5,  # headroom: CPU device passes are slow
        )
        dev.warm_for_population([kp.pub for kp in com.keys.values()], max_sweep=32)
        com.start()
        client = com.clients[0]
        client.request_timeout = 1.0
        try:
            assert await client.submit("put a 1") == "ok"
            com.replica("r0").kill()
            assert await client.submit("put b 2", retries=120) == "ok"
            survivors = [r for r in com.replicas if r.id != "r0"]
            assert all(r.view >= 1 for r in survivors)
            assert await client.submit("get a", retries=120) == "1"
        finally:
            await com.stop()
            svc.close()
        assert svc.device_passes > 0

    run(scenario(), timeout=300)


def test_bad_signature_still_rejected_through_service():
    """A forged vote is dropped on the device route while the quorum
    still forms from valid ones."""

    async def scenario():
        from simple_pbft_tpu_torch.crypto.signer import Signer
        from simple_pbft_tpu_torch.messages import Commit

        dev, svc = _device_service()
        com = LocalCommittee.build(n=4, clients=1, verifier_factory=lambda: svc)
        dev.warm_for_population([kp.pub for kp in com.keys.values()], max_sweep=32)
        com.start()
        try:
            r0 = com.replica("r0")
            # forged commit vote: r2's key but claiming r1, on a
            # not-yet-quorate slot
            forged = Commit(view=0, seq=200, digest="f" * 64)
            Signer("r1", com.keys["r2"].seed).sign_msg(forged)
            forged.sender = "r1"
            await com.net.endpoint("r2").send("r0", forged.to_wire())
            assert await com.clients[0].submit("put k v") == "ok"
            for _ in range(100):
                if r0.metrics.get("bad_sig", 0) >= 1:
                    break
                await asyncio.sleep(0.1)
            assert r0.metrics.get("bad_sig", 0) >= 1
        finally:
            await com.stop()
            svc.close()
        assert svc.device_passes > 0 and svc.cpu_passes == 0

    run(scenario())
