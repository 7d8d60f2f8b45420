#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (simple_pbft_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernel and the native host helpers from the sources in
the repository, then, printing one JSON line per phase:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc / g++ build seconds and the kernel's register report;
3. kernel   — the fused-accumulate kernel against its plain PyTorch
              version at every batch bucket: exact int32 equality, the
              kernel's and the plain version's times, and the bound;
4. verifier — a GpuVerifier over an n=64 committee + 64 clients (key
              bank of 256) verifying an 8,192-item batch with seeded
              corruptions; the bitmap must equal the CPU oracle item by
              item; e2e verifies/s and the device-pass time;
5. committee (the main path) — an n=16 (f=5) LocalCommittee whose
              replicas share one VerifyService over one GpuVerifier, with
              the CPU routes turned off; 16 clients x 25 puts; every reply
              "ok", one state digest equal to a plain KVStore's, every
              pass on the device, and the kernel launched;
6. the kernels line, and last the device line.

Any failed check raises and the script exits non-zero. Without a CUDA
device it exits non-zero before printing any result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
INT32_OPS_PER_SM_CLOCK = 64  # Hopper: 64 int32 lanes per SM
BOOST_HZ = 1.98e9  # H100 SXM maximum SM clock
ROW_PAYLOAD_BYTES = 3 * 17 * 4  # 204 of a row's 256 bytes are limbs
MULS_PER_MADD = 7 * 17 * 17 + 17  # 7 field muls + one mul_small per position


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps, warmup=1):
    """Median device time of `fn` in ms, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    props = torch.cuda.get_device_properties(0)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), sms=props.multi_processor_count,
         memory_bytes=props.total_memory, torch=torch.__version__,
         cuda=torch.version.cuda)


def phase_build():
    """nvcc for the kernel and g++ for the native helpers, all started
    together; every one must succeed."""
    from concurrent.futures import ThreadPoolExecutor

    from simple_pbft_tpu_torch import native
    from simple_pbft_tpu_torch.ops import comb

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        jobs = {
            "fused_accumulate.cu": pool.submit(timed, comb.accumulate_kernel.library),
            "pbft_native.cpp": pool.submit(timed, native.available),
            "ed25519.cpp": pool.submit(timed, native.ed25519_available),
            "canonjson.cpp": pool.submit(timed, native.canonjson_available),
        }
        results = {k: f.result() for k, f in jobs.items()}
    for name, (ok, _) in results.items():
        check(ok, f"build of {name} failed")
    ptxas = [ln.strip() for ln in comb.accumulate_kernel.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds={k: round(v[1], 3) for k, v in results.items()},
         wall_seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas)


def accumulate_bound(idx):
    """Least time for the accumulate on this input: the larger of the
    bytes it must move over the memory rate and its int32 multiplies
    over the card's int32 rate. Rows are counted once per distinct row
    this input touches."""
    import torch

    npos, batch = idx.shape
    distinct = torch.unique(idx).numel()
    nbytes = idx.numel() * 4 + distinct * ROW_PAYLOAD_BYTES + 4 * 17 * batch * 4
    ops = batch * npos * MULS_PER_MADD
    sms = torch.cuda.get_device_properties(idx.device).multi_processor_count
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (sms * INT32_OPS_PER_SM_CLOCK * BOOST_HZ)
    return {
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "int32_muls": ops, "distinct_rows": distinct,
    }


def phase_kernel():
    import numpy as np
    import torch

    from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
    from simple_pbft_tpu_torch.crypto.gpu_verifier import BUCKETS, KeyBank
    from simple_pbft_tpu_torch.ops import comb

    dev = torch.device("cuda")
    n_keys = 64
    bank = KeyBank(initial_capacity=n_keys, device=dev)
    for i in range(n_keys):
        bank.lookup(ref.public_key(i.to_bytes(2, "little") * 16))
    check(len(bank._index) == n_keys, "bank did not take 64 keys")
    f_flat = bank.device_tables()
    rpk = comb.NPOS * comb.FWINDOW
    rng = np.random.default_rng(20261017)
    rows = {}
    for batch in BUCKETS:
        s = torch.from_numpy(rng.integers(0, 16, (comb.NPOS, batch), dtype=np.int32)).to(dev)
        k = torch.from_numpy(rng.integers(0, 16, (comb.NPOS, batch), dtype=np.int32)).to(dev)
        base = torch.from_numpy((rng.integers(0, n_keys, batch) * rpk).astype(np.int32)).to(dev)
        idx = comb.accumulate_index(s, k, base).contiguous()
        got = comb.accumulate_kernel(idx, f_flat)
        want = comb.madd_loop_plain(idx, f_flat).reshape(4 * 17, batch)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        check(err == 0 and torch.equal(got, want), f"kernel != plain at B={batch}")
        rows[batch] = {
            "max_abs_err": err,
            "kernel_ms": cuda_ms(lambda: comb.accumulate_kernel(idx, f_flat), 20, 3),
            "plain_ms": cuda_ms(lambda: comb.madd_loop_plain(idx, f_flat), 3, 1),
            **accumulate_bound(idx),
        }
    emit("kernel", name="fused_accumulate", keys=n_keys,
         launches_in_phase=comb.accumulate_kernel.launches,
         by_batch={str(b): v for b, v in rows.items()})
    return rows


def _corrupt(items, rng, count):
    """Seeded corruptions at `count` distinct positions, five kinds in
    turn: flipped S byte, flipped R byte, wrong message, swapped key,
    S >= L. -> (items, positions)."""
    from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
    from simple_pbft_tpu_torch.crypto.verifier import BatchItem

    items = list(items)
    pos = rng.choice(len(items), size=count, replace=False)
    for n, p in enumerate(pos):
        it = items[p]
        sig = bytearray(it.sig)
        kind = n % 5
        if kind == 0:
            sig[32 + int(rng.integers(0, 28))] ^= 1 << int(rng.integers(0, 8))
            items[p] = BatchItem(it.pubkey, it.msg, bytes(sig))
        elif kind == 1:
            sig[int(rng.integers(0, 32))] ^= 1 << int(rng.integers(0, 8))
            items[p] = BatchItem(it.pubkey, it.msg, bytes(sig))
        elif kind == 2:
            items[p] = BatchItem(it.pubkey, it.msg + b"!", it.sig)
        elif kind == 3:
            other = items[(p + 1) % len(items)].pubkey
            if other == it.pubkey:
                other = items[(p + 2) % len(items)].pubkey
            items[p] = BatchItem(other, it.msg, it.sig)
        else:
            s = int.from_bytes(it.sig[32:], "little") + ref.L
            items[p] = BatchItem(it.pubkey, it.msg, it.sig[:32] + s.to_bytes(32, "little"))
    return items, sorted(int(p) for p in pos)


def phase_verifier():
    import numpy as np
    import torch

    from simple_pbft_tpu_torch.config import make_test_committee
    from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
    from simple_pbft_tpu_torch.crypto.gpu_verifier import GpuVerifier, prepare_wire_batch
    from simple_pbft_tpu_torch.crypto.verifier import BatchItem, kernel_equivalent_cpu_verifier
    from simple_pbft_tpu_torch.ops import comb
    from simple_pbft_tpu_torch.ops import field25519 as fe

    _, keys = make_test_committee(n=64, clients=64)
    pairs = sorted(keys.items())
    t0 = time.perf_counter()
    gpu = GpuVerifier(initial_keys=128 + 32)
    gpu.warm_for_population([kp.pub for _, kp in pairs], max_sweep=8192)
    warm_s = time.perf_counter() - t0
    check(gpu._bank._cap == 256 and len(gpu._bank._index) == 128, "bank shape")
    t0 = time.perf_counter()
    signed = []
    for i in range(1024):
        _, kp = pairs[i % len(pairs)]
        msg = b"chip smoke vote %d" % i
        signed.append(BatchItem(kp.pub, msg, ref.sign(kp.seed, msg)))
    sign_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    items, bad = _corrupt(signed * 8, rng, 200)
    oracle = kernel_equivalent_cpu_verifier().verify_batch(items)
    check(sum(oracle) == len(items) - len(bad), "oracle rejected an honest item")
    launches = comb.accumulate_kernel.launches
    got = gpu.verify_batch(items)
    check(comb.accumulate_kernel.launches == launches + 1, "verify did not launch the kernel")
    mismatch = [i for i, (a, b) in enumerate(zip(got, oracle)) if a != b]
    check(not mismatch, f"bitmap != oracle at {mismatch[:10]}")

    e2e = []
    for _ in range(5):
        t0 = time.perf_counter()
        gpu.verify_batch(items)
        e2e.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    prep, _ = prepare_wire_batch(items, gpu._bank)
    prep_s = time.perf_counter() - t0
    dev = gpu.device
    wire, a_idx, pre = (torch.from_numpy(a).to(dev) for a in prep.arrays())
    tables = gpu._bank.device_tables()
    pass_ms = cuda_ms(lambda: comb.fused_verify_wire_kernel(wire, a_idx, tables, pre), 5)
    # stage split of one pass: window extraction, accumulate, inversion+encode
    stages = []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        s_w = fe.extract_windows_dev(wire[:, 0:32], 4, 64)
        k_w = fe.extract_windows_dev(wire[:, 32:64], 4, 64)
        r_y = fe.extract_windows_dev(wire[:, 64:96], 15, 17)
        r_sign = wire[:, 95].to(torch.int32) >> 7
        ev[1].record()
        p = comb.fused_accumulate(s_w, k_w, a_idx * (64 * 256), tables)
        ev[2].record()
        ok = comb._encode_and_compare(p, r_y, r_sign, pre)
        ev[3].record()
        torch.cuda.synchronize()
        check(ok.cpu().tolist() == got, "stage-split pass disagrees")
        stages.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    split = [statistics.median(s[i] for s in stages) for i in range(3)]
    emit("verifier", batch=len(items), bank_keys=128, bank_capacity=gpu._bank._cap,
         bank_bytes=gpu._bank._np.nbytes, corrupted=len(bad), matches_oracle=True,
         verifies_per_s_e2e=len(items) / statistics.median(e2e),
         e2e_s=sorted(e2e), host_prep_s=prep_s, device_pass_ms=pass_ms,
         stage_ms={"extract": split[0], "accumulate": split[1],
                   "invert_encode": split[2]},
         warm_s=warm_s, sign_s=sign_s)


def phase_committee():
    import asyncio

    from simple_pbft_tpu_torch.app import KVStore
    from simple_pbft_tpu_torch.committee import LocalCommittee
    from simple_pbft_tpu_torch.crypto.coalesce import VerifyService
    from simple_pbft_tpu_torch.crypto.gpu_verifier import GpuVerifier
    from simple_pbft_tpu_torch.ops import comb

    n, n_clients, per_client = 16, 16, 25
    gpu = GpuVerifier(initial_keys=n + n_clients + 32)
    svc = VerifyService(gpu, cpu_cutoff=0, max_batch=8192, dispatch_deadline=None)
    ops = {c: [f"put c{c}k{i} v{i}" for i in range(per_client)] for c in range(n_clients)}
    latencies = []

    async def client_loop(client, mine):
        for op in mine:
            t0 = time.perf_counter()
            reply = await client.submit(op)
            latencies.append(time.perf_counter() - t0)
            check(reply == "ok", f"reply {reply!r} to {op!r}")

    async def drive(com):
        com.start()
        try:
            t0 = time.perf_counter()
            await asyncio.gather(*(client_loop(c, ops[i]) for i, c in enumerate(com.clients)))
            elapsed = time.perf_counter() - t0
            # a client returns after f+1 replies: let the slowest replica
            # finish executing before the committee stops
            for _ in range(600):
                if len({r.app.state_digest() for r in com.replicas}) == 1:
                    break
                await asyncio.sleep(0.05)
            return elapsed
        finally:
            await com.stop()

    try:
        # steady-state timers as bench_consensus.py sets them for clean
        # runs: a 2 s default view timer fires under device-pass latency
        # and sends replicas into view changes this run does not study
        com = LocalCommittee.build(n=n, clients=n_clients, verifier_factory=lambda: svc,
                                   view_timeout=30.0)
        for c in com.clients:
            c.request_timeout = 30.0
        svc.warm_for_population(list(com.cfg.pubkeys.values()), max_sweep=8192)
        comb.accumulate_kernel.launches = 0
        elapsed = asyncio.run(asyncio.wait_for(drive(com), 600))
        launches = comb.accumulate_kernel.launches
    finally:
        svc.close()
    expected = KVStore()
    for mine in ops.values():
        for op in mine:
            expected.apply(op)
    digests = {r.app.state_digest() for r in com.replicas}
    check(len(latencies) == n_clients * per_client, "not every request answered")
    top = max(r.executed_seq for r in com.replicas)
    lagging = {r.id: {k: v for k, v in r.metrics.items() if v and isinstance(v, int)}
               for r in com.replicas if r.executed_seq != top}
    bad_sig = sum(r.metrics.get("bad_sig", 0) for r in com.replicas)
    check(bad_sig == 0, f"{bad_sig} honest signatures rejected on the device path")
    check(digests == {expected.state_digest()},
          f"replica state != expected KV state: {len(digests)} digests, "
          f"executed_seq {sorted(r.executed_seq for r in com.replicas)}, "
          f"lagging replicas' metrics {lagging}")
    check(svc.device_passes > 0, "no device pass")
    check(svc.cpu_passes == 0, f"{svc.cpu_passes} CPU passes")
    check(svc.watchdog_failovers == 0, "watchdog failover")
    check(launches > 0, "main path never launched the kernel")
    check(gpu.post_warm_compiles == 0, "a first-time shape after warmup")
    lat = sorted(latencies)
    emit("committee", n=n, f=(n - 1) // 3, clients=n_clients, requests=len(lat),
         committed_req_per_s=len(lat) / elapsed, elapsed_s=elapsed,
         p50_ms=lat[len(lat) // 2] * 1e3, p99_ms=lat[int(len(lat) * 0.99) - 1] * 1e3,
         device_passes=svc.device_passes, cpu_passes=svc.cpu_passes,
         watchdog_failovers=svc.watchdog_failovers, kernel_launches=launches,
         device_items=gpu.device_items, device_seconds=gpu.device_seconds,
         bucket_hits=gpu.shape_snapshot()["bucket_hits"])
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import simple_pbft_tpu_torch  # noqa: F401 — fails before any output when absent

    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    rows = phase_kernel()
    phase_verifier()
    launches = phase_committee()
    top = rows[max(rows)]
    err = max(r["max_abs_err"] for r in rows.values())
    kernels = [{
        "name": "fused_accumulate",
        "route": "cuda",
        "source": "simple_pbft_tpu_torch/csrc/fused_accumulate.cu",
        "replaces": "simple_pbft_tpu/ops/comb.py:473 (_madd_loop_pallas)",
        "launches": launches,
        "max_abs_err": err,
        "max_abs_diff": err,
        "batch": max(rows),
        "ms": top["kernel_ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
    }]
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
