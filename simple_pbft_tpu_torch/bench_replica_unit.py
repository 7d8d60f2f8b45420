"""One-replica unit microbench: the measured per-core consensus ceiling.

    python -m simple_pbft_tpu_torch.bench_replica_unit [--n 100]
        [--blocks 16] [--batch 128] [--modes plain,qc]
        [--verifier cpu|gpu] [--device cuda|cpu] [--out FILE]

ONE backup replica (r1) runs the full runtime — drain sweeps, batched
signature verification, quorum tallies, ordered execution, replies —
while the rest of the committee is PRE-SIGNED traffic fed at line rate
through its transport queue. No other replica shares the core, so the
number is the per-core ceiling of the replica runtime itself.

Traffic per block (plain mode): one signed PrePrepare carrying `batch`
client-signed requests, then 2f+1 Prepare and 2f+1 Commit votes from
distinct peers (r1's own votes complete the quorums). QC mode: the two
votes' worth of traffic collapses to two aggregate QuorumCerts (one
pairing check each, on the host's native BLS code) — the
certificate-size thesis in docs/PROTOCOL.md.

Checkpoint traffic is emitted by r1 but never stabilizes (no live peers
to answer); the watermark window is sized past the run so GC never
gates progress — stated in the record as checkpointing=off.

Prints ONE JSON line per mode, the JAX package's record (the root
bench_replica_unit.py) field for field. With ``--verifier gpu`` the
record adds `platform` ("gpu" or "cpu", from the torch device), the
verify service's counters, the launches of the accumulate and verdict
kernels after the warm (`kernel_launches`), and the bank's key count
(`bank_keys`). ``RU_PROFILE=1`` prints a cProfile of the drive on stderr;
``RU_MAX_SWEEP`` (default 4096) is the largest drain sweep the warm
covers.

The port's edits to the JAX script: ``--verifier gpu`` in place of
``tpu`` (one GpuVerifier(initial_keys=n + clients + 8) behind the
port's VerifyService, warmed for the key population), ``--verifier``
defaults to ``gpu``, and ``--device`` (default cuda; ``cpu`` runs the
kernels' plain versions) in place of the BENCH_FORCE_CPU set-up. Without
CUDA the default run raises before it signs anything. ``--out`` appends
the lines to a file only when given.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
from typing import Dict, List

N_CLIENTS = 8


def _emit(rec: dict, out_path: str | None) -> None:
    line = json.dumps(rec)
    os.write(1, (line + "\n").encode())
    if out_path:
        if os.path.dirname(out_path):
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "a") as f:
            f.write(line + "\n")


def build_traffic(cfg, keys, n_clients: int, blocks: int, batch: int):
    """Pre-sign `blocks` full consensus rounds as wire bytes for backup
    r1. Returns (wire messages, total requests)."""
    from .consensus import qc as qc_mod
    from .crypto.signer import Signer
    from .messages import Commit, PrePrepare, Prepare, Request

    signers = {rid: Signer(rid, keys[rid].seed) for rid in cfg.replica_ids}
    client_ids = [f"c{i}" for i in range(n_clients)]
    csigners = {cid: Signer(cid, keys[cid].seed) for cid in client_ids}
    quorum = cfg.quorum  # 2f+1
    others = [rid for rid in cfg.replica_ids if rid != "r1"]
    bls_sks: Dict[str, int] = {}
    if cfg.qc_mode:
        from .crypto import bls

        for rid in cfg.replica_ids[: quorum + 1]:
            bls_sks[rid] = bls.keygen(keys[rid].seed)[0]
    wire: List[bytes] = []
    ts = {cid: 0 for cid in client_ids}
    for seq in range(1, blocks + 1):
        reqs = []
        for j in range(batch):
            cid = client_ids[j % n_clients]
            ts[cid] += 1
            r = Request(
                client_id=cid,
                timestamp=ts[cid],
                operation=f"put k{j} s{seq}",
            )
            csigners[cid].sign_msg(r)
            reqs.append(r)
        block = [r.to_dict() for r in reqs]
        pp = PrePrepare(
            view=0,
            seq=seq,
            digest=PrePrepare.block_digest(block),
            block=block,
        )
        signers["r0"].sign_msg(pp)
        wire.append(pp.to_wire())
        if not cfg.qc_mode:
            for rid in others[:quorum]:
                p = Prepare(view=0, seq=seq, digest=pp.digest)
                signers[rid].sign_msg(p)
                wire.append(p.to_wire())
            for rid in others[:quorum]:
                c = Commit(view=0, seq=seq, digest=pp.digest)
                signers[rid].sign_msg(c)
                wire.append(c.to_wire())
        else:
            for phase in ("prepare", "commit"):
                shares = {
                    rid: qc_mod.sign_share(sk, phase, 0, seq, pp.digest)
                    for rid, sk in bls_sks.items()
                }
                cert = qc_mod.build_qc(
                    phase, 0, seq, pp.digest, shares, quorum
                )
                if cert is None:
                    raise RuntimeError(f"{phase} QC aggregation failed at seq {seq}")
                signers["r0"].sign_msg(cert)
                wire.append(cert.to_wire())
    return wire, blocks * batch


async def run_mode(
    mode: str, n: int, blocks: int, batch: int, verifier: str = "gpu",
    device: str = "cuda",
) -> dict:
    from .app import KVStore
    from .config import make_test_committee
    from .consensus.replica import Replica
    from .transport.local import LocalNetwork

    qc_mode = mode == "qc"
    cfg, keys = make_test_committee(
        n=n,
        clients=N_CLIENTS,
        qc_mode=qc_mode,
        checkpoint_interval=64,
        watermark_window=blocks + 128,
    )
    net = LocalNetwork()
    t0 = time.perf_counter()
    wire, total_reqs = build_traffic(cfg, keys, N_CLIENTS, blocks, batch)
    prep_s = time.perf_counter() - t0

    svc = dev = None
    if verifier == "gpu":
        # one replica, verify offloaded through the coalescing service
        # (async dispatch overlaps the device pass with the next sweep's
        # decode)
        from .crypto.coalesce import VerifyService
        from .crypto.gpu_verifier import GpuVerifier

        dev = GpuVerifier(initial_keys=n + N_CLIENTS + 8, device=device)
        # the default warm covers a maximal drain sweep; RU_MAX_SWEEP
        # shrinks it where each bucket's warm pass is slow (the plain
        # versions on a CPU)
        dev.warm_for_population(
            [kp.pub for kp in keys.values()],
            max_sweep=int(os.environ.get("RU_MAX_SWEEP", "4096")),
        )
        svc = VerifyService(dev)

    replica = Replica(
        node_id="r1",
        cfg=cfg,
        seed=keys["r1"].seed,
        transport=net.endpoint("r1"),
        app=KVStore(),
        verifier=svc,
    )
    feeder = net.endpoint("r0")
    for raw in wire:
        await feeder.send("r1", raw)

    profiler = None
    if os.environ.get("RU_PROFILE"):
        import cProfile

        profiler = cProfile.Profile()
        profiler.enable()
    replica.start()
    t0 = time.perf_counter()
    deadline = t0 + 600.0
    while replica.executed_seq < blocks and time.perf_counter() < deadline:
        await asyncio.sleep(0.01)
    elapsed = time.perf_counter() - t0
    if profiler is not None:
        import pstats

        profiler.disable()
        # stderr: the record stays the last line of stdout
        pstats.Stats(profiler, stream=sys.stderr).sort_stats("tottime").print_stats(25)
    done = replica.executed_seq
    stats = replica.stats
    rec = {
        "bench": "replica_unit",
        "mode": mode,
        "n": n,
        "quorum": cfg.quorum,
        "blocks": blocks,
        "batch": batch,
        "wire_messages": len(wire),
        "completed_blocks": done,
        "ok": done == blocks,
        "req_s": round(done * batch / elapsed, 1) if elapsed > 0 else 0.0,
        "ms_per_req": round(1e3 * elapsed / max(1, done * batch), 4),
        "elapsed_s": round(elapsed, 2),
        "presign_s": round(prep_s, 1),
        "verify_items": stats.verify_items,
        "verify_s": round(stats.verify_seconds, 2),
        "verify_share": round(stats.verify_seconds / elapsed, 3)
        if elapsed > 0
        else 0.0,
        "sig_cache_hits": replica.metrics.get("sig_cache_hits", 0),
        "checkpointing": "emit-only (no peers answer)",
        "verifier": getattr(replica.verifier, "name", "?"),
    }
    if svc is not None:
        launches = dev.shape_snapshot()["kernel_launches_after_warm"]
        rec.update(
            platform="gpu" if dev.device.type == "cuda" else "cpu",
            svc_device_passes=svc.device_passes,
            svc_cpu_passes=svc.cpu_passes,
            # null until a device pass ran — the EMA's constructor seed
            # (30 ms) must never read as a measured round trip
            svc_rtt_ms_ema=(
                round(svc.rtt_ms, 1) if svc.device_passes else None
            ),
            kernel_launches={k: launches[k] for k in ("fused_accumulate", "encode_verdict")},
            bank_keys=len(dev._bank._index),
        )
    await replica.stop()
    if svc is not None:
        svc.close()
    return rec


async def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--modes", default="plain,qc")
    ap.add_argument("--verifier", default="gpu", choices=["cpu", "gpu"])
    ap.add_argument(
        "--device", default="cuda",
        help="gpu verifier: the torch device it runs on (cpu runs the "
        "kernels' plain versions)",
    )
    ap.add_argument("--out", default=None,
                    help="also append each record to this file")
    args = ap.parse_args(argv)
    modes = [m.strip() for m in args.modes.split(",")]
    for mode in modes:
        if mode not in ("plain", "qc"):
            ap.error(f"unknown mode {mode!r}: valid are plain, qc")
    if args.verifier == "gpu":
        from . import resolve_device

        resolve_device(args.device)  # no CUDA: raise before any work
    for mode in modes:
        rec = await run_mode(
            mode, args.n, args.blocks, args.batch, verifier=args.verifier,
            device=args.device,
        )
        _emit(rec, args.out)


if __name__ == "__main__":
    asyncio.run(main())
