"""The port's committee end to end on the CPU, against the JAX package's.

A port LocalCommittee (n=4) runs with every signature verified by
GpuVerifier(device="cpu") behind one coalescing VerifyService with the
small-pile CPU route turned off, so every pass is a device pass. The
same requests through a JAX-package committee with its default CPU
verifier must end in the same state digest.
"""

import asyncio

from simple_pbft_tpu import config as jconfig
from simple_pbft_tpu.committee import LocalCommittee as JaxCommittee
from simple_pbft_tpu_torch import config as tconfig
from simple_pbft_tpu_torch.app import KVStore
from simple_pbft_tpu_torch.committee import LocalCommittee
from simple_pbft_tpu_torch.crypto.coalesce import VerifyService
from simple_pbft_tpu_torch.crypto.gpu_verifier import GpuVerifier
from simple_pbft_tpu_torch.ops import comb

REQUESTS = [f"put k{i} v{i}" for i in range(4)]


def _drive(com):
    """Submit REQUESTS in order; before stopping, wait until every replica
    has executed them (a client may return on speculative replies, before
    any replica has committed the last block, so equal digests alone do
    not mean the last request executed)."""
    expected = KVStore()
    for op in REQUESTS:
        expected.apply(op)

    async def scenario():
        com.start()
        try:
            replies = [await com.clients[0].submit(op) for op in REQUESTS]
            for _ in range(200):
                if {r.app.state_digest() for r in com.replicas} == {expected.state_digest()}:
                    break
                await asyncio.sleep(0.05)
            return replies
        finally:
            await com.stop()

    return asyncio.run(asyncio.wait_for(scenario(), 120))


def test_port_committee_commits_on_device_path_and_matches_jax():
    gpu = GpuVerifier(device="cpu", initial_keys=4 + 1 + 32)
    svc = VerifyService(gpu, cpu_cutoff=0, max_batch=32, dispatch_deadline=None)
    try:
        com = LocalCommittee.build(n=4, clients=1, verifier_factory=lambda: svc)
        keys = [com.cfg.pubkeys[i] for i in sorted(com.cfg.pubkeys)]
        svc.warm_for_population(keys, max_sweep=32)
        launches = comb.accumulate_kernel.launches
        calls = gpu.device_calls
        replies = _drive(com)
    finally:
        svc.close()
    assert replies == ["ok"] * 4
    assert svc.cpu_passes == 0 and svc.watchdog_failovers == 0
    assert svc.device_passes > 0 and gpu.device_calls > calls
    assert gpu.post_warm_compiles == 0
    # CPU tensors take the plain version: the CUDA kernel never launched
    assert comb.accumulate_kernel.launches == launches
    digests = {r.app.state_digest() for r in com.replicas}
    expected = KVStore()
    for op in REQUESTS:
        expected.apply(op)
    assert digests == {expected.state_digest()}

    ref = JaxCommittee.build(n=4, clients=1)
    assert _drive(ref) == ["ok"] * 4
    assert {r.app.state_digest() for r in ref.replicas} == digests


def test_jax_config_doc_loads_into_port_unchanged():
    cfg, _ = jconfig.make_test_committee(n=4, clients=2)
    doc = jconfig.config_doc(cfg)
    base, _ = tconfig.make_test_committee(n=4, clients=0)
    ported = tconfig.config_from_doc(base, doc)
    assert tconfig.config_doc(ported) == doc
    assert ported.pubkeys == cfg.pubkeys
    assert ported.replica_ids == cfg.replica_ids
