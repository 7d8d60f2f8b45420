#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (simple_pbft_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the two CUDA kernels of the device pass and the native host
helpers from the sources in the repository, then, printing one JSON line
per phase:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc / g++ build seconds and both kernels' register reports;
3. field    — the kernels' field header (csrc/field25519.cuh) on the
              card, through the verdict library's test entry: multiply,
              square, inversion and canonical reduction against
              ops/field25519.py on edge and random inputs, exactly;
4. kernel   — at every batch bucket, the accumulate kernel (index mode on
              random windows, wire mode on random wire bytes, each with
              the P its wrapper picks) and the verdict kernel against
              their plain PyTorch versions: exact equality in canonical
              limbs; the kernels' and the plain versions' times, and the
              bounds;
5. verifier — a GpuVerifier over an n=64 committee + 64 clients (key
              bank of 256) verifying an 8,192-item batch with seeded
              corruptions; the bitmap must equal the CPU oracle item by
              item; e2e verifies/s; the device pass's time with its split
              between the two kernels, taken by CUDA events in the same
              passes; a torch.profiler trace of one pass, which must hold
              exactly the two kernels besides copies;
6. committee (the main path) — an n=16 (f=5) LocalCommittee whose
              replicas share one VerifyService over one GpuVerifier, with
              the CPU routes turned off; 16 clients x 25 puts; every reply
              "ok", one state digest equal to a plain KVStore's, every
              pass on the device, and both kernels launched; rates and
              latencies from a drive without the profiler, the device's
              idle share from a second drive on a fresh committee, traced
              over its middle half;
7. deployment (this slice's main path) — the port's launcher as a
              subprocess: 16 replica processes (n=16, f=5) with
              --verifier gpu over TCP, each verifying through its own
              VerifyService(GpuVerifier) on the card, and one client
              sending 800 puts, all in flight. Every reply
              must arrive; every node must make device passes (each one
              launch of both kernels) with no watchdog failover, no
              quarantine and no first-time shape after its warm, and all
              nodes must stop on one executed sequence. The client's
              line, boot seconds, the card's memory per process, each
              node's passes, and node r0's device profile (armed with
              --device-profile) are printed;
8. bench      — python -m simple_pbft_tpu_torch.bench (no error, on the
              card) and python -m simple_pbft_tpu_torch.bench_consensus
              --configs 2 --verifier gpu --seconds 10 (commits, device
              passes);
9. the kernels line (launches of the committee and the deployment), and
   last the device line.

Any failed check raises and the script exits non-zero. Without a CUDA
device it exits non-zero before printing any result.

``--view-timeout 2`` runs the committee at the configuration's default
view timer; without it the committee runs with 30 s, as bench_consensus.py
does for clean runs.
"""

import glob
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
# Hopper: 64 int32 lanes per SM; a 32 x 32 -> 64-bit multiply (IMAD.WIDE)
# is assumed to issue as fast as an int32 one, which keeps the bound low
INT32_OPS_PER_SM_CLOCK = 64
BOOST_HZ = 1.98e9  # H100 SXM maximum SM clock
ROW_PAYLOAD_BYTES = 3 * 17 * 4  # 204 of a row's 256 bytes are limbs
WIDE_PRODUCTS_PER_MUL = 100  # a radix-2^25.5 field multiply: 10 x 10 products
FIELD_MULS_PER_MADD = 7  # the mixed add's doubling of Z is an add here
LEGACY_MULS_PER_MADD = 7 * 17 * 17 + 17  # the 17 x 15 count (slice 1's bound)
SQ_PRODUCTS = 55  # a radix-2^25.5 square
# the JAX tail per lane: Montgomery batch inversion (~3 multiplies a lane
# and one Fermat chain, 254 squarings and 11 multiplies, per 128 lanes),
# then x and y (2 multiplies)
TAIL_MULS_PER_LANE = 3 + 2
CHAIN_SQUARES, CHAIN_MULS, CHAIN_WIDTH = 254, 11, 128
# X, Y and Z of the accumulator (T is not read), R, precheck, verdict
TAIL_BYTES_PER_LANE = 3 * 17 * 4 + 32 + 1 + 1


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
    """nvcc for the two kernels and g++ for the native helpers, all
    started together; every one must succeed."""
    from concurrent.futures import ThreadPoolExecutor

    from simple_pbft_tpu_torch import native
    from simple_pbft_tpu_torch.ops import comb

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        jobs = {
            "fused_accumulate.cu": pool.submit(timed, comb.accumulate_kernel.library),
            "encode_verdict.cu": pool.submit(timed, comb.encode_kernel.library),
            "pbft_native.cpp": pool.submit(timed, native.available),
            "ed25519.cpp": pool.submit(timed, native.ed25519_available),
            "canonjson.cpp": pool.submit(timed, native.canonjson_available),
        }
        results = {k: f.result() for k, f in jobs.items()}
    for name, (ok, _) in results.items():
        check(ok, f"build of {name} failed")
    ptxas = {
        name: [ln.strip() for ln in k.build_log.splitlines()
               if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        for name, k in (("fused_accumulate", comb.accumulate_kernel),
                        ("encode_verdict", comb.encode_kernel))
    }
    emit("build", seconds={k: round(v[1], 3) for k, v in results.items()},
         wall_seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas)


def _bound(nbytes, products, device):
    """The larger of bytes over the memory rate and wide products over
    the card's multiply issue rate, in ms."""
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = products / (sms * INT32_OPS_PER_SM_CLOCK * BOOST_HZ)
    return {
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "wide_products": products,
    }


def accumulate_bound(idx, input_bytes):
    """Least time for the accumulate on this input. Rows count once per
    distinct row the input touches; `input_bytes` is what the mode reads
    besides the rows (the indices, or the wire scalars and key rows)."""
    import torch

    npos, batch = idx.shape
    distinct = torch.unique(idx).numel()
    nbytes = input_bytes + distinct * ROW_PAYLOAD_BYTES + 4 * 17 * batch * 4
    return {
        **_bound(nbytes, batch * npos * FIELD_MULS_PER_MADD * WIDE_PRODUCTS_PER_MUL, idx.device),
        "distinct_rows": distinct,
        "legacy_int32_muls": batch * npos * LEGACY_MULS_PER_MADD,
    }


def tail_bound(batch, device):
    """Least time for the verdict tail: the JAX function's work (batch
    inversion) and bytes. `design_products` is what the per-lane
    inversion spends instead."""
    chains = -(-batch // CHAIN_WIDTH)
    products = ((batch * TAIL_MULS_PER_LANE + chains * CHAIN_MULS) * WIDE_PRODUCTS_PER_MUL
                + chains * CHAIN_SQUARES * SQ_PRODUCTS)
    return {
        **_bound(batch * TAIL_BYTES_PER_LANE, products, device),
        "design_products": batch * (CHAIN_SQUARES * SQ_PRODUCTS
                                    + (CHAIN_MULS + 2) * WIDE_PRODUCTS_PER_MUL),
    }


def canonical_point(p):
    """(4·17, B) or (4, 17, B) -> (4, 17, B) with canonical coordinates."""
    from simple_pbft_tpu_torch.ops import field25519 as fe

    p = p.reshape(4, 17, -1)
    return fe.to_canonical(p.transpose(0, 1)).transpose(0, 1)


def phase_field():
    """The header's arithmetic on the card against ops/field25519.py."""
    import numpy as np
    import torch

    from simple_pbft_tpu_torch.ops import comb
    from simple_pbft_tpu_torch.ops import field25519 as fe

    dev = torch.device("cuda")
    p = fe.P_INT
    rng = np.random.default_rng(255)
    edge = [0, 1, 2, 19, p - 1, p, p + 1, p + 18, 2**255 - 1, 2**254, 2**255 - 20]
    rand = [int.from_bytes(bytes(r), "little") % 2**255
            for r in rng.integers(0, 256, (4085, 32), dtype=np.uint8)]
    limbs = np.stack([fe._int_to_limbs_np(v) for v in edge + rand], axis=1)
    # the weak form at its maxima: limb 0 up to 2^15 + 38, others 2^15 + 2^11
    weak = rng.integers(0, (1 << 15) + (1 << 11), (17, 4096), dtype=np.int32)
    weak[0] = rng.integers(0, (1 << 15) + 39, 4096, dtype=np.int32)
    weak[:, 0] = (1 << 15) + (1 << 11) - 1
    weak[0, 0] = (1 << 15) + 38
    a = torch.from_numpy(np.concatenate([limbs, weak], axis=1)).to(dev).contiguous()
    b = a.flip(1).contiguous()
    plain = {"mul": lambda: fe.mul(a, b), "sq": lambda: fe.mul(a, a),
             "invert": lambda: fe.invert(a), "canonical": lambda: a}
    rows = {}
    for op, fn in plain.items():
        got = comb.encode_kernel.field_op(op, a, b)
        want = fe.to_canonical(fn())
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"field header {op} != ops/field25519.py")
        rows[op] = {"n": a.shape[1], "equal": True}
    emit("field", edge_values=len(edge), **rows)


def parts_sweep_ms(wire, a_idx, f_flat):
    """K1 in wire mode at every P, through the library's C entry (these
    launches are outside the wrapper and its count): how the wrapper's
    choice of P compares."""
    import torch

    from simple_pbft_tpu_torch.ops import comb

    lib = comb.accumulate_kernel.library()
    batch = wire.shape[0]
    out = torch.empty((4 * 17, batch), dtype=torch.int32, device=wire.device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(log2_parts):
        rc = lib.fused_accumulate_launch(
            None, wire.data_ptr(), a_idx.data_ptr(), f_flat.data_ptr(), out.data_ptr(),
            comb.NPOS, batch, log2_parts, f_flat.shape[0], stream)
        check(rc == 0, f"sweep launch failed: {rc}")

    return {str(1 << lp): cuda_ms(lambda: launch(lp), 10, 2) for lp in range(5)}


def phase_kernel():
    import numpy as np
    import torch

    from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
    from simple_pbft_tpu_torch.crypto.gpu_verifier import BUCKETS, KeyBank
    from simple_pbft_tpu_torch.ops import comb
    from simple_pbft_tpu_torch.ops import field25519 as fe

    dev = torch.device("cuda")
    n_keys = 64
    bank = KeyBank(initial_capacity=n_keys, device=dev)
    for i in range(n_keys):
        bank.lookup(ref.public_key(i.to_bytes(2, "little") * 16))
    check(len(bank._index) == n_keys, "bank did not take 64 keys")
    f_flat = bank.device_tables()
    rpk = comb.NPOS * comb.FWINDOW
    k1 = comb.accumulate_kernel
    rng = np.random.default_rng(20261017)
    rows = {}
    for batch in BUCKETS:
        parts = k1.parts_for(batch, dev)
        # index mode: random windows, as fused_accumulate gives them
        s = torch.from_numpy(rng.integers(0, 16, (comb.NPOS, batch), dtype=np.int32)).to(dev)
        k = torch.from_numpy(rng.integers(0, 16, (comb.NPOS, batch), dtype=np.int32)).to(dev)
        base = torch.from_numpy((rng.integers(0, n_keys, batch) * rpk).astype(np.int32)).to(dev)
        idx = comb.accumulate_index(s, k, base).contiguous()
        got = k1(idx, f_flat)
        want = canonical_point(comb.madd_loop_plain(idx, f_flat, parts=parts))
        torch.cuda.synchronize()
        err_index = int((got.reshape(4, 17, batch).long() - want.long()).abs().max().item())
        check(err_index == 0, f"accumulate (index mode) != plain at B={batch}")
        # wire mode: random wire bytes and key rows, as the main path gives
        wire = torch.from_numpy(rng.integers(0, 256, (batch, 96), dtype=np.uint8)).to(dev)
        a_idx = torch.from_numpy(rng.integers(0, n_keys, batch).astype(np.int32)).to(dev)
        widx = comb.wire_index_plain(wire, a_idx)
        acc = k1.wire(wire, a_idx, f_flat)
        want_w = canonical_point(comb.madd_loop_plain(widx, f_flat, parts=parts))
        torch.cuda.synchronize()
        err_wire = int((acc.reshape(4, 17, batch).long() - want_w.long()).abs().max().item())
        check(err_wire == 0, f"accumulate (wire mode) != plain at B={batch}")
        # verdict tail: every fourth lane's R is its own point's encoding
        pre = torch.from_numpy(rng.random(batch) < 0.9).to(dev)
        p = acc.reshape(4, 17, batch)
        _, xy = comb.encode_and_compare_plain(p, *comb.r_from_wire(wire), pre, affine=True)
        xy = xy.cpu().numpy()
        wire_np = wire.cpu().numpy()
        for lane in range(0, batch, 4):
            x = fe._limbs_to_int_np(xy[:17, lane:lane + 1])
            y = fe._limbs_to_int_np(xy[17:, lane:lane + 1])
            wire_np[lane, 64:] = np.frombuffer((y | (x & 1) << 255).to_bytes(32, "little"),
                                               np.uint8)
        wire = torch.from_numpy(wire_np).to(dev)
        pre[0::4] = True
        r_y, r_sign = comb.r_from_wire(wire)
        want_ok, want_xy = comb.encode_and_compare_plain(p, r_y, r_sign, pre, affine=True)
        ok, got_xy = comb.encode_kernel(acc, wire, pre, affine=True)
        torch.cuda.synchronize()
        err_tail = int((got_xy.long() - want_xy.long()).abs().max().item())
        check(torch.equal(ok, want_ok) and err_tail == 0, f"verdict kernel != plain at B={batch}")
        check(int(ok.sum()) > 0, f"no lane matched at B={batch}")
        rows[batch] = {
            "parts": parts,
            "index": {
                "max_abs_err": err_index,
                "kernel_ms": cuda_ms(lambda: k1(idx, f_flat), 20, 3),
                "plain_ms": cuda_ms(lambda: comb.madd_loop_plain(idx, f_flat, parts=parts), 2, 1),
                **accumulate_bound(idx, idx.numel() * 4),
            },
            "wire": {
                "max_abs_err": err_wire,
                "kernel_ms": cuda_ms(lambda: k1.wire(wire, a_idx, f_flat), 20, 3),
                "plain_ms": cuda_ms(lambda: comb.madd_loop_plain(
                    comb.wire_index_plain(wire, a_idx), f_flat, parts=parts), 2, 1),
                **accumulate_bound(widx, batch * (64 + 4)),
                "parts_sweep_ms": parts_sweep_ms(wire, a_idx, f_flat),
            },
            "verdict": {
                "max_abs_err": err_tail, "matches": int(ok.sum()),
                "kernel_ms": cuda_ms(lambda: comb.encode_kernel(acc, wire, pre), 20, 3),
                "plain_ms": cuda_ms(lambda: comb.encode_and_compare_plain(
                    p, r_y, r_sign, pre), 2, 1),
                **tail_bound(batch, dev),
            },
        }
    emit("kernel", keys=n_keys, resident_threads=k1.resident_threads(dev),
         launches_in_phase={"fused_accumulate": k1.launches,
                            "encode_verdict": comb.encode_kernel.launches},
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
    launches = comb.accumulate_kernel.launches, comb.encode_kernel.launches
    got = gpu.verify_batch(items)
    check((comb.accumulate_kernel.launches, comb.encode_kernel.launches)
          == (launches[0] + 1, launches[1] + 1), "verify did not launch both kernels once")
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
    # the pass as fused_verify_wire_kernel runs it, its two launches split
    # by a CUDA event between them: the parts sum to the whole
    stages = []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        acc = comb.accumulate_kernel.wire(wire, a_idx, tables)
        ev[1].record()
        ok = comb.encode_kernel(acc, wire, pre)
        ev[2].record()
        torch.cuda.synchronize()
        check(ok.cpu().tolist() == got, "stage-split pass disagrees")
        parts = [ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])]
        whole = ev[0].elapsed_time(ev[2])
        check(abs(sum(parts) - whole) < 0.01, f"stages {parts} do not sum to {whole}")
        stages.append(parts + [whole])
    split = [statistics.median(s[i] for s in stages) for i in range(3)]
    profile = profile_pass(prep, tables)
    emit("verifier", batch=len(items), bank_keys=128, bank_capacity=gpu._bank._cap,
         bank_bytes=gpu._bank._np.nbytes, corrupted=len(bad), matches_oracle=True,
         verifies_per_s_e2e=len(items) / statistics.median(e2e),
         e2e_s=sorted(e2e), host_prep_s=prep_s, device_pass_ms=pass_ms,
         stage_ms={"accumulate": split[0], "encode_verdict": split[1], "pass": split[2]},
         stage_ms_runs=stages, profile=profile, warm_s=warm_s, sign_s=sign_s)


def profile_pass(prep, tables):
    """torch.profiler over one pass as GpuVerifier dispatches it (host
    arrays up, the pass, verdicts down): the device must run exactly the
    two kernels, besides copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simple_pbft_tpu_torch.ops import comb

    dev = tables.device
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wire, a_idx, pre = (torch.from_numpy(a).to(dev) for a in prep.arrays())
        comb.fused_verify_wire_kernel(wire, a_idx, tables, pre).cpu()
        torch.cuda.synchronize()
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e.name for e in device_events if e.name.startswith(("Memcpy", "Memset"))]
    kernels = [e.name for e in device_events if not e.name.startswith(("Memcpy", "Memset"))]
    check(len(kernels) == 2 and "fused_accumulate_kernel" in kernels[0]
          and "encode_verdict_kernel" in kernels[1],
          f"profiled pass ran {kernels}, not the two kernels")
    return {"kernels": kernels, "copies": len(copies),
            "kernel_us": [e.time_range.elapsed_us() for e in device_events
                          if e.name in kernels]}


def _stage_totals_ms():
    """Per-stage (count, total ms) of the process's span recorder."""
    from simple_pbft_tpu_torch import spans

    return {k: (v["count"], v["count"] * v["mean"])
            for k, v in spans.snapshot()["stages"].items()}


def phase_committee(view_timeout):
    """The main path, driven twice on fresh committees over one service:
    a timed drive without the profiler (the launch counts, rates and
    latencies), then a traced drive whose middle half, past start-up and
    before the tail, is a torch.profiler window (the device's idle
    share)."""
    import asyncio

    import torch
    from torch.profiler import ProfilerActivity, profile

    from simple_pbft_tpu_torch.app import KVStore
    from simple_pbft_tpu_torch.committee import LocalCommittee
    from simple_pbft_tpu_torch.crypto.coalesce import VerifyService
    from simple_pbft_tpu_torch.crypto.gpu_verifier import GpuVerifier
    from simple_pbft_tpu_torch.ops import comb

    n, n_clients, per_client = 16, 16, 25
    total = n_clients * per_client
    gpu = GpuVerifier(initial_keys=n + n_clients + 32)
    svc = VerifyService(gpu, cpu_cutoff=0, max_batch=8192, dispatch_deadline=None)
    ops = {c: [f"put c{c}k{i} v{i}" for i in range(per_client)] for c in range(n_clients)}
    expected = KVStore()
    for mine in ops.values():
        for op in mine:
            expected.apply(op)

    async def client_loop(client, mine, latencies):
        for op in mine:
            t0 = time.perf_counter()
            reply = await client.submit(op)
            latencies.append(time.perf_counter() - t0)
            check(reply == "ok", f"reply {reply!r} to {op!r}")

    async def traced_window(latencies, prof, window):
        while len(latencies) < total // 4:
            await asyncio.sleep(0.005)
        torch.cuda.synchronize()
        prof.start()
        t0 = time.perf_counter()
        done = len(latencies)
        while len(latencies) < 3 * total // 4:
            await asyncio.sleep(0.005)
        torch.cuda.synchronize()
        window.update(seconds=time.perf_counter() - t0, requests=len(latencies) - done)
        prof.stop()

    async def drive(com, latencies, tracer=None):
        com.start()
        try:
            t0 = time.perf_counter()
            await asyncio.gather(*(client_loop(c, ops[i], latencies)
                                   for i, c in enumerate(com.clients)),
                                 *([tracer] if tracer else []))
            elapsed = time.perf_counter() - t0
            # a client may return on speculative replies, before any
            # replica has committed the last block (then every replica
            # holds the same, earlier state): wait for the expected state
            # before the committee stops
            for _ in range(600):
                if {r.app.state_digest() for r in com.replicas} == {expected.state_digest()}:
                    break
                await asyncio.sleep(0.05)
            return elapsed
        finally:
            await com.stop()

    def committee():
        com = LocalCommittee.build(n=n, clients=n_clients, verifier_factory=lambda: svc,
                                   view_timeout=view_timeout)
        for c in com.clients:
            c.request_timeout = 30.0
        svc.warm_for_population(list(com.cfg.pubkeys.values()), max_sweep=8192)
        return com

    def check_state(com, latencies, what):
        check(len(latencies) == total, f"{what}: not every request answered")
        top = max(r.executed_seq for r in com.replicas)
        lagging = {r.id: {k: v for k, v in r.metrics.items() if v and isinstance(v, int)}
                   for r in com.replicas if r.executed_seq != top}
        bad_sig = sum(r.metrics.get("bad_sig", 0) for r in com.replicas)
        check(bad_sig == 0, f"{what}: {bad_sig} honest signatures rejected on the device path")
        digests = {r.app.state_digest() for r in com.replicas}
        check(digests == {expected.state_digest()},
              f"{what}: replica state != expected KV state: {len(digests)} digests, "
              f"executed_seq {sorted(r.executed_seq for r in com.replicas)}, "
              f"lagging replicas' metrics {lagging}")

    latencies, traced_latencies, window = [], [], {}
    try:
        com = committee()
        stages_before = _stage_totals_ms()
        comb.accumulate_kernel.launches = 0
        comb.encode_kernel.launches = 0
        elapsed = asyncio.run(asyncio.wait_for(drive(com, latencies), 600))
        launches = {"fused_accumulate": comb.accumulate_kernel.launches,
                    "encode_verdict": comb.encode_kernel.launches}
        passes = {"device": svc.device_passes, "cpu": svc.cpu_passes,
                  "watchdog": svc.watchdog_failovers, "items": gpu.device_items,
                  "seconds": gpu.device_seconds,
                  "buckets": gpu.shape_snapshot()["bucket_hits"]}
        stages = {k: {"count": c - stages_before.get(k, (0, 0.0))[0],
                      "total_ms": t - stages_before.get(k, (0, 0.0))[1]}
                  for k, (c, t) in _stage_totals_ms().items()}
        check_state(com, latencies, "timed drive")
        traced = committee()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        traced_elapsed = asyncio.run(asyncio.wait_for(
            drive(traced, traced_latencies, traced_window(traced_latencies, prof, window)),
            600))
        check_state(traced, traced_latencies, "traced drive")
    finally:
        svc.close()
    busy_s = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA) * 1e-6
    check(busy_s > 0, "the traced window saw no device activity")
    check(passes["device"] > 0, "no device pass")
    check(passes["cpu"] == 0, f"{passes['cpu']} CPU passes")
    check(passes["watchdog"] == 0, "watchdog failover")
    check(svc.cpu_passes == 0 and svc.watchdog_failovers == 0, "traced drive left the device")
    for name, count in launches.items():
        check(count > 0, f"main path never launched {name}")
    check(launches["fused_accumulate"] == launches["encode_verdict"] == passes["device"],
          f"launches {launches} != one of each per device pass ({passes['device']})")
    check(gpu.post_warm_compiles == 0, "a first-time shape after warmup")
    lat = sorted(latencies)
    emit("committee", n=n, f=(n - 1) // 3, clients=n_clients, view_timeout=view_timeout,
         requests=len(lat), executed_seq=sorted(r.executed_seq for r in com.replicas),
         views=sorted(r.view for r in com.replicas),
         committed_req_per_s=len(lat) / elapsed, elapsed_s=elapsed,
         p50_ms=lat[len(lat) // 2] * 1e3, p99_ms=lat[int(len(lat) * 0.99) - 1] * 1e3,
         device_passes=passes["device"], cpu_passes=passes["cpu"],
         watchdog_failovers=passes["watchdog"], kernel_launches=launches,
         device_items=passes["items"], device_seconds=passes["seconds"],
         span_totals=stages, bucket_hits=passes["buckets"],
         traced_drive={"committed_req_per_s": total / traced_elapsed,
                       "elapsed_s": traced_elapsed,
                       "window_s": window["seconds"], "window_requests": window["requests"],
                       "device_busy_s": busy_s,
                       "device_idle_share": 1.0 - busy_s / window["seconds"]})
    return launches


# all 800 in flight, one burst: each replica process routes its own
# piles through the adaptive CPU cutoff (20-120 items on the H100's hosts
# seen). At the client's default 64 a node's piles held 60-110 items and
# 9 of 16 nodes never reached the card; at 256, 150-165 items, under 2x
# the cutoff; at 800, 515-631
DEPLOY_N, DEPLOY_LOAD = 16, 800
DEPLOY_CONCURRENCY = DEPLOY_LOAD


def _last_json(text, key):
    """The last line of `text` that is a JSON object holding `key`."""
    for line in reversed(text.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if key in rec:
                return rec
    return None


def _build_mtimes():
    from simple_pbft_tpu_torch import BUILD_DIR

    return {os.path.basename(p): os.path.getmtime(p)
            for p in glob.glob(os.path.join(BUILD_DIR, "*.so"))}


def _sample_memory(deploy_dir, n, done, out):
    """While the nodes serve (every status file written, the launcher not
    yet done), sample the card's used memory as this process's
    mem_get_info sees it, and keep the most."""
    import torch

    status = [os.path.join(deploy_dir, "log", f"r{i}.status.json") for i in range(n)]
    while not done.is_set() and not all(os.path.exists(s) for s in status):
        time.sleep(0.1)
    while not done.is_set():
        free, total = torch.cuda.mem_get_info(0)
        out["card_used_max"] = max(out.get("card_used_max", 0), total - free)
        time.sleep(0.5)


def _free_base_port(n):
    """A base port whose n replica ports (base..base+n-1) and client port
    (base+500) are free on localhost, derived from the pid so that two
    smokes on one machine start apart."""
    import socket

    for step in range(200):
        base = 40000 + ((os.getpid() + step * 37) % 400) * 50
        try:
            socks = []
            for port in [*range(base, base + n), base + 500]:
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                socks.append(sock)
                sock.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    check(False, "no free range of ports for the deployment")


def phase_deployment():
    """The port's launcher as a subprocess: n replica processes with the
    gpu verifier over TCP and one client. Each node's final flight frame
    (<deploy>/log/<id>.flight.jsonl, written after the replica stopped)
    holds its verify-service counters, its kernel launches after warm and
    its executed sequence. Every process the launcher started is gone,
    and the deployment directory removed, when the phase returns, also
    when it fails."""
    deploy_dir = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    try:
        return _deployment(deploy_dir)
    finally:
        shutil.rmtree(deploy_dir, ignore_errors=True)


def _deployment(deploy_dir):
    import torch

    libs_before = _build_mtimes()
    torch.cuda.init()
    free, total = torch.cuda.mem_get_info(0)
    mem = {"card_used_before": total - free}
    cmd = [sys.executable, "-m", "simple_pbft_tpu_torch.launch",
           "-n", str(DEPLOY_N), "--verifier", "gpu", "--transport", "tcp",
           "--load", str(DEPLOY_LOAD), "--concurrency", str(DEPLOY_CONCURRENCY),
           "--keep", "--deploy-dir", deploy_dir,
           "--base-port", str(_free_base_port(DEPLOY_N)), "--device-profile", "120"]
    log_path = os.path.join(deploy_dir, "launch.stderr")
    done = threading.Event()
    sampler = threading.Thread(target=_sample_memory,
                               args=(deploy_dir, DEPLOY_N, done, mem), daemon=True)
    t0 = time.perf_counter()
    with open(log_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=err,
                                text=True, start_new_session=True)
        sampler.start()
        try:
            out, _ = proc.communicate(timeout=900)
        finally:
            done.set()
            if proc.poll() is None:
                # the launcher's session holds every node: stop them all
                os.killpg(proc.pid, signal.SIGTERM)
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
            sampler.join(timeout=30)
    wall_s = time.perf_counter() - t0
    with open(log_path) as fh:
        tail = fh.read()[-3000:]
    check(proc.returncode == 0, f"launch exited {proc.returncode}: {tail}")
    client = _last_json(out, "ops")
    check(client is not None, f"no client line in the launcher's output: {out[-2000:]}")
    check(client["ops"] == DEPLOY_LOAD, f"{client['ops']} of {DEPLOY_LOAD} replies")
    ready = [ln for ln in out.splitlines() if ln.startswith("nodes ready:")]
    boot_s = float(ready[-1].split(" in ")[1].split()[0])
    nodes = {}
    for i in range(DEPLOY_N):
        with open(os.path.join(deploy_dir, "log", f"r{i}.flight.jsonl")) as fh:
            snap = json.loads(fh.read().splitlines()[-1])
        verify, shapes = snap["verify"], snap["verify"]["device_shapes"]
        nodes[f"r{i}"] = {
            "executed_seq": snap["replica"]["executed_seq"],
            "view": snap["replica"]["view"],
            "device_passes": verify["device_passes"],
            "device_pass_items": verify["device_pass_items"],
            "cpu_passes": verify["cpu_passes"],
            "cpu_pass_items": verify["cpu_pass_items"],
            "max_coalesced": verify["max_coalesced"],
            "rtt_ms_ema": verify["rtt_ms_ema"],
            "cpu_rate_ema": verify["cpu_rate_ema"],
            "watchdog_failovers": verify["watchdog_failovers"],
            "quarantine_entries": verify["quarantine_entries"],
            "post_warm_compiles": shapes["post_warm_compiles"],
            "bucket_hits": shapes["bucket_hits"],
            "kernel_launches": shapes["kernel_launches_after_warm"],
        }
    rebuilt = sorted(k for k, v in _build_mtimes().items() if libs_before.get(k) != v)
    frontier = sorted({v["executed_seq"] for v in nodes.values()})
    launches = {k: sum(v["kernel_launches"][k] for v in nodes.values())
                for k in ("fused_accumulate", "encode_verdict")}
    profile = _profile_summary(os.path.join(deploy_dir, "log", "device_profile"))
    card_used = mem.get("card_used_max", 0) - mem["card_used_before"]
    emit("deployment", n=DEPLOY_N, f=(DEPLOY_N - 1) // 3, processes=DEPLOY_N,
         transport="tcp", load=DEPLOY_LOAD, concurrency=DEPLOY_CONCURRENCY,
         client=client, boot_s=boot_s,
         wall_s=wall_s, executed_seq=frontier,
         views=sorted({v["view"] for v in nodes.values()}),
         memory={"card_used_bytes": card_used,
                 "per_process_bytes": card_used / DEPLOY_N},
         kernel_launches=launches, rebuilt_libraries=rebuilt,
         device_profile=profile,
         mac_replies=_kx_available(), nodes=nodes)
    for node_id, v in nodes.items():
        check(v["device_passes"] > 0, f"{node_id} made no device pass: {v}")
        check(v["watchdog_failovers"] == 0 and v["quarantine_entries"] == 0,
              f"{node_id} left the device: {v}")
        check(v["post_warm_compiles"] == 0, f"{node_id} met a first-time shape: {v}")
        check(v["kernel_launches"] == {"fused_accumulate": v["device_passes"],
                                       "encode_verdict": v["device_passes"]},
              f"{node_id}: launches {v['kernel_launches']} != one of each per device pass")
    check(len(frontier) == 1 and frontier[0] > 0, f"nodes stopped on {frontier}")
    check(all(f"{k}/kernel" in profile["kernels"] for k in launches),
          f"node r0's device profile holds no launch of a kernel: {profile}")
    return launches


def _kx_available():
    from simple_pbft_tpu_torch.crypto import mac

    return mac.kx_available()


def _profile_summary(out_dir):
    """Node r0's torch.profiler capture: the trace files, their events by
    category, and the events naming either kernel."""
    files = sorted(glob.glob(os.path.join(out_dir, "*.json")))
    categories, kernels = {}, {}
    for path in files:
        with open(path) as fh:
            for ev in json.load(fh).get("traceEvents", []):
                cat = str(ev.get("cat", ""))
                categories[cat] = categories.get(cat, 0) + 1
                name = str(ev.get("name", ""))
                for k in ("fused_accumulate", "encode_verdict"):
                    if k in name:
                        kernels[f"{k}/{cat}"] = kernels.get(f"{k}/{cat}", 0) + 1
    return {"files": [os.path.basename(f) for f in files], "categories": categories,
            "kernels": kernels}


def _run_json(args, key, timeout):
    """Run a module of the port; -> its last JSON line holding `key`."""
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    rec = _last_json(proc.stdout, key)
    check(proc.returncode == 0 and rec is not None,
          f"{args[0]} exited {proc.returncode}: {proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    return rec


def phase_bench():
    t0 = time.perf_counter()
    bench = _run_json(["simple_pbft_tpu_torch.bench"], "metric", 600)
    bench_s = time.perf_counter() - t0
    check("error" not in bench and bench["platform"] == "gpu" and bench["value"] > 0,
          f"bench line: {bench}")
    t0 = time.perf_counter()
    cons = _run_json(["simple_pbft_tpu_torch.bench_consensus", "--configs", "2",
                      "--verifier", "gpu", "--seconds", "10"], "committed_req_s", 600)
    cons_s = time.perf_counter() - t0
    check(cons["committed_req_s"] > 0 and cons["svc_device_passes"] > 0,
          f"bench_consensus line: committed_req_s {cons['committed_req_s']}, "
          f"device passes {cons.get('svc_device_passes')}")
    keys = ("config", "n", "verifier", "clients", "outstanding", "window_s",
            "committed_req_s", "completed_total", "p50_ms", "p99_ms", "client_timeouts",
            "replica_exec_min", "replica_exec_max", "verify_calls", "verify_batch_mean",
            "verify_ms_mean", "svc_device_passes", "svc_device_items", "svc_cpu_passes",
            "svc_cpu_items", "svc_max_coalesced", "svc_rtt_ms_ema",
            "svc_watchdog_failovers", "svc_device_shapes")
    emit("bench", bench=bench, bench_s=bench_s,
         bench_consensus={k: cons.get(k) for k in keys}, bench_consensus_s=cons_s)


def kernel_rows(rows, by_path):
    """The kernels line: each kernel at the largest bucket, in the mode
    the main path runs it; `launches` sums the paths' counts."""
    launches = {k: sum(p[k] for p in by_path.values())
                for k in ("fused_accumulate", "encode_verdict")}
    top = max(rows)
    k1 = rows[top]["wire"]
    tail = rows[top]["verdict"]
    err_k1 = max(max(r["index"]["max_abs_err"], r["wire"]["max_abs_err"]) for r in rows.values())
    err_tail = max(r["verdict"]["max_abs_err"] for r in rows.values())
    return [{
        "name": "fused_accumulate",
        "route": "cuda",
        "source": "simple_pbft_tpu_torch/csrc/fused_accumulate.cu",
        "replaces": "simple_pbft_tpu/ops/comb.py:473 (_madd_loop_pallas)",
        "launches": launches["fused_accumulate"],
        "launches_by_path": {p: v["fused_accumulate"] for p, v in by_path.items()},
        "max_abs_err": err_k1,
        "batch": top,
        "parts": rows[top]["parts"],
        "ms": k1["kernel_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "library": "none: no PyTorch call computes it",
    }, {
        "name": "encode_verdict",
        "route": "cuda",
        "source": "simple_pbft_tpu_torch/csrc/encode_verdict.cu",
        "replaces": "simple_pbft_tpu/ops/comb.py:506 (batch_invert) + :529 "
                    "(_encode_and_compare), XLA",
        "launches": launches["encode_verdict"],
        "launches_by_path": {p: v["encode_verdict"] for p, v in by_path.items()},
        "max_abs_err": err_tail,
        "batch": top,
        "ms": tail["kernel_ms"],
        "plain_ms": tail["plain_ms"],
        "bound_ms": tail["bound_ms"],
        "bound_by": tail["bound_by"],
        "library_ms": None,
        "library": "none: no PyTorch call computes it",
    }]


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--view-timeout", type=float, default=30.0,
                    help="the committee's view timer in seconds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import simple_pbft_tpu_torch  # noqa: F401 — fails before any output when absent

    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    phase_field()
    rows = phase_kernel()
    phase_verifier()
    by_path = {"committee": phase_committee(args.view_timeout)}
    by_path["deployment"] = phase_deployment()
    phase_bench()
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernel_rows(rows, by_path)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
