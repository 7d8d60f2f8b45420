#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (simple_pbft_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the four CUDA kernels (the device pass's two, the ladder
mode's, and the quorum tally) and the native host helpers (BLS too) from
the sources in the repository, then, printing one JSON line per phase:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc / g++ build seconds and the kernels' register reports;
3. field    — the kernels' field headers on the card, through the
              verdict library's test entry: csrc/field25519.cuh's
              multiply, square, inversion, canonical reduction,
              pow22523 and negation (one thread an element), and
              csrc/field25519_coop.cuh's multiply, square, inversion and
              pow22523 (5 threads an element), against ops/field25519.py
              on edge and random inputs, exactly; then K9's point
              operations through the ladder library's test entry (the
              doubling, the cached addition and the decompression, 5
              threads a point) against ops/edwards.py, exactly;
3b. sim     — the port's deterministic simulator (sim.py, no kernel: its
              committee verifies on the CPU) on the STORM scenario of
              tests/test_sim.py, seed 11, twice: both runs pass their
              oracles with the same trace fingerprint;
4. kernel   — at every batch bucket, the accumulate kernel (index mode on
              random windows, wire mode on random wire bytes, each with
              the P its wrapper picks) and the verdict kernel against
              their plain PyTorch versions: exact equality in canonical
              limbs; the kernels' and the plain versions' times (the
              verdict kernel's also over 50 back-to-back calls, which
              hide its wrapper's host time), and the
              bounds; then the verdict kernel alone at B = 7 and 8,193,
              which leave a partial group of 5 threads, a partial warp
              and a partial block;
5. modes    — the accumulate kernel's seven configurations: fused
              windows of 4, 5 and 6 bits in dense and packed rows, and the
              comb mode. For each, at B = 8, 512 and 8192, K1 against its
              plain version (wire and index mode for fused, comb mode for
              comb), exactly in canonical limbs; for comb, the verdict
              kernel's limb entry against encode_and_compare_plain; then a
              GpuVerifier(mode, window) verifying an 8,192-item batch with
              seeded corruptions, its bitmap equal to the CPU oracle item
              by item (BASELINE config 3's key population, the bench's 16
              signers at w = 6), with the launches of that drive counted
              per configuration; times, P and bounds at B = 8192. The
              eighth configuration is the ladder mode (no key bank): the
              ladder kernel K9 against verify_kernel_plain at B = 7, 8,
              512, 8192 and 8,193 on config 3's items with seeded
              corruptions and on a fixed adversarial batch (verdicts and
              canonical affine accumulators, exactly), each batch also
              timed over 50 back-to-back calls, the profiler's kernel
              time at 8192, its registers (no spill), then a
              GpuVerifier(mode="ladder") on the 8,192 items, one K9
              launch a verify and no launch of the other two kernels;
6. mesh     — the multi-device path on Mesh(["cuda:0"] * 4), one card
              holding four positions, at BASELINE config 3's sizes (its
              8,192-item batch as 128 instances of 64 votes): the tally
              kernel, added into a nonzero vector, against
              quorum_tally_plain at B = 1, 2, 7, 8, 33, 512, 2048, 8192
              and 8,193 by n_inst = 1, 2, 3, 4, 128, 130 and 1,000 on
              both load paths (16-byte and scalar), and on wrapping
              weights, exactly; at 8192 x 128 on each path its one-call,
              back-to-back and profiler times and its wrapper's host
              time, beside the bound and torch.mv's time where it runs;
              both quorum steps
              (parallel/sharded_verify.py) on the mesh of 4 and a mesh of
              1, verdicts equal to the oracle and counts equal to its
              tally on every position, k launches of each kernel on a
              mesh of k, and a profiler trace of one comb step (k tally
              launches, one zeroed counts vector and no psum add on the
              one card); meshed
              GpuVerifiers in fused w=4 dense, comb and ladder on the
              8,192 items, bitmaps equal to the oracle, k launches a pass;
              the port's dryrun_multichip(4); an n=4 committee sharing one
              meshed fused verifier (tests/test_committee.py's); the
              steps' and passes' times at mesh 1 and 4;
7. verifier — a GpuVerifier over an n=64 committee + 64 clients (key
              bank of 256) verifying an 8,192-item batch with seeded
              corruptions; the bitmap must equal the CPU oracle item by
              item; e2e verifies/s; the device pass's time with its split
              between the two kernels, taken by CUDA events in the same
              passes; a torch.profiler trace of one pass, which must hold
              exactly the two kernels besides copies;
7b. costmodel — the card's gather rate: torch.index_select of the rows one
              fused w=4 pass reads at B = 8192 (8192 x 64 random rows)
              from a 256-slot bank's table, in dense (256 B) and packed
              (128 B) rows, as 4-, 8- and 16-byte elements, the median
              of 20 calls by CUDA events; the
              port's crypto/costmodel.shape_cost("fused", 4, 8192); the
              verifier phase's K1 time as an achieved gather rate
              against the cost model's "h100" ceiling; and K1 on cold
              rows: 8,192 distinct signed messages on the verifier's
              128-key bank (bitmap all true, K1 equal to its plain
              version), its one-call and back-to-back times beside the
              tiled batch's and the distinct rows each gathers;
8. committee (the main path) — an n=16 (f=5) LocalCommittee whose
              replicas share one VerifyService over one GpuVerifier, with
              the CPU routes turned off; 16 clients x 25 puts; every reply
              "ok", one state digest equal to a plain KVStore's, every
              pass on the device, and both kernels launched; rates and
              latencies from a drive without the profiler, the device's
              idle share from a second drive on a fresh committee, traced
              over its middle half;
9. deployment (a main path) — the port's launcher as a
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
9b. replica_unit (a main path) — python -m
              simple_pbft_tpu_torch.bench_replica_unit --verifier gpu at
              the JAX script's defaults: one replica of n = 100 (f = 33)
              fed 16 pre-signed blocks of 128 requests, verifying through
              VerifyService(GpuVerifier) on the card, in plain and qc
              mode. Each mode must commit every block with device passes
              and launches of both kernels;
9c. config3 (a main path) — python -m simple_pbft_tpu_torch.bench_consensus
              --configs 3 --verifier gpu --seconds 10: BASELINE config 3,
              a committee of 64 (f = 21) in one process with 8 clients x
              128 requests in flight and every verify pile on the card.
              It must commit, with device passes only, no watchdog
              failover, no first-time shape after the warm and launches of
              both kernels;
9d. config4 (a main path) — python -m
              simple_pbft_tpu_torch.bench_consensus --configs 4 --verifier
              gpu --seconds 10 --verify-cpu-cutoff 0: BASELINE config 4,
              256 replicas (f = 85) and 8 clients in one process with BLS
              quorum certificates, 264 keys in a fused w=4 bank of 512
              slots, the reference's cap. It must commit with no key over
              the cap and the same checks as 9c;
9e. config5 (a main path) — python -m
              simple_pbft_tpu_torch.bench_consensus --configs 3 --storm
              --verifier gpu --verify-cpu-cutoff 0 --crashes 3: BASELINE
              config 5, the committee of 64 with the bench's 8 clients x 128
              in flight, whose current primary is crash-stopped three times;
              every VIEW-CHANGE's and NEW-VIEW's nested signatures verify on
              the card. storm_checks: three crashes, the survivors' last
              flight frames in one view of at least 3, views installed and
              three NEW-VIEWs sent, no honest certificate refused by a
              precheck, every survivor executing after its first frame in the
              final view, device passes only (no reroute, no watchdog
              failover, no first-time shape), no key over the cap, and one
              launch of K1 and of the verdict kernel a chunk and none of K9.
              It prints the largest dispatch and the dispatches split into
              chunks of the top bucket;
9f. n100 (a main path) — python -m simple_pbft_tpu_torch.bench_consensus
              --configs 100,qc100 --verifier gpu --verify-cpu-cutoff 0: the
              committee of 100 (BASELINE's metric) without and with BLS
              certificates, each committing with the device checks of 9e and
              the bank's cap of 512. 9b to 9f print the card memory their
              process used;
10. bench     — python -m simple_pbft_tpu_torch.bench at its defaults
              (fused, w = 5, dense rows), at BENCH_WINDOW=4 and at
              BENCH_MODE=comb (no error, on the card, each line carrying
              its mode, window and rowpack) and python -m
              simple_pbft_tpu_torch.bench_consensus --configs 2 --verifier
              gpu --seconds 10 (commits, device passes);
11. the kernels line (launches of the committee, the deployment, the
   replica unit, configs 3, 4 and 5, n = 100, the modes phase's verifier drives and the
   mesh phase's drives; each kernel's `configs` map; K9's launches are
   the ladder drive's), and last the device line.

Every phase prints its seconds (`phase_seconds` of the `done` line).

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
ROW_PAYLOAD_BYTES = 3 * 17 * 4  # 204 of a dense row's 256 bytes are limbs
PACKED_PAYLOAD_BYTES = 3 * 9 * 4  # 108 of a packed row's 128 bytes
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
# the comb path's R: 17 limbs and a sign, int32
LIMB_TAIL_BYTES_PER_LANE = 3 * 17 * 4 + 17 * 4 + 4 + 1 + 1
# the ladder (K9) per lane, at the least work a verify needs: 256 steps of
# a doubling from (X, Y, Z) (4 squares, then 4 multiplies to extended
# coordinates) and an addition of a cached (Y - X, Y + X, Z, 2dT) addend
# (4 multiplies, then 3 back to (X, Y, Z)), as K1's madd is counted in its
# Niels form. Then B + Q (9); two decompressions (255 squares, 251 of
# them in pow22523, and 20 multiplies each); the projective comparison (2)
LADDER_STEP_PRODUCTS = 4 * SQ_PRODUCTS + 11 * WIDE_PRODUCTS_PER_MUL
DECOMPRESS_PRODUCTS = 255 * SQ_PRODUCTS + 20 * WIDE_PRODUCTS_PER_MUL
LADDER_PRODUCTS_PER_LANE = (256 * LADDER_STEP_PRODUCTS + 2 * DECOMPRESS_PRODUCTS
                            + (9 + 2) * WIDE_PRODUCTS_PER_MUL)
# what the kernel spends a lane: the same 4 squares and 11 multiplies a
# step, but on the group every square costs a multiply's 100 products
# (20 a thread); two decompressions of 274 multiplies (262 in pow22523),
# A's xy, the table (11: 2d T of B and Q, B + Q, 2d T of B + Q) and the
# comparison (2)
LADDER_DESIGN_MULS_PER_LANE = 256 * 15 + 2 * 274 + 1 + 11 + 2
# A.y, R.y (17 limbs), two signs, two (256,) bit columns, precheck, verdict
LADDER_BYTES_PER_LANE = 2 * 17 * 4 + 2 * 4 + 2 * 256 * 4 + 1 + 1


_T0 = time.perf_counter()


def emit(phase, **kw):
    """One phase's JSON line, with the seconds since the smoke started."""
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - _T0, **kw}), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps, warmup=1, calls=1):
    """Median device time of `fn` in ms, CUDA events around each call; with
    `calls` > 1, around that many back-to-back calls, per call, so that a
    wrapper's host time hides behind the previous call's kernel."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
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
    """nvcc for the four kernels and g++ for the native helpers (BLS among
    them, which the replica unit's qc mode pairs on), all
    started together; every one must succeed. The kernels' libraries of
    an earlier run are removed first, so every run builds them from the
    sources and has their ptxas reports."""
    from concurrent.futures import ThreadPoolExecutor

    from simple_pbft_tpu_torch import build_dir, native
    from simple_pbft_tpu_torch.ops import comb, ladder, quorum

    for k in (comb.accumulate_kernel, comb.encode_kernel, ladder.ladder_kernel,
              quorum.tally_kernel):
        so = os.path.join(build_dir(), k.LIB_NAME)
        if os.path.exists(so):
            os.remove(so)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        jobs = {
            "fused_accumulate.cu": pool.submit(timed, comb.accumulate_kernel.library),
            "encode_verdict.cu": pool.submit(timed, comb.encode_kernel.library),
            "ladder_verify.cu": pool.submit(timed, ladder.ladder_kernel.library),
            "quorum_tally.cu": pool.submit(timed, quorum.tally_kernel.library),
            "pbft_native.cpp": pool.submit(timed, native.available),
            "ed25519.cpp": pool.submit(timed, native.ed25519_available),
            "canonjson.cpp": pool.submit(timed, native.canonjson_available),
            "bls381.cpp": pool.submit(timed, native.bls_available),
        }
        results = {k: f.result() for k, f in jobs.items()}
    for name, (ok, _) in results.items():
        check(ok, f"build of {name} failed")
    ptxas = {
        name: [ln.strip() for ln in k.build_log.splitlines()
               if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        for name, k in (("fused_accumulate", comb.accumulate_kernel),
                        ("encode_verdict", comb.encode_kernel),
                        ("ladder_verify", ladder.ladder_kernel),
                        ("quorum_tally", quorum.tally_kernel))
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


def accumulate_bound(idx, input_bytes, payload=ROW_PAYLOAD_BYTES):
    """Least time for the accumulate on this input. `idx` is the (npos, B)
    row indices, or a list of them, one for each table (the comb's two
    streams): every row is one mixed add, and rows count once per distinct
    row the input touches, at `payload` bytes (204 dense, 108 packed);
    `input_bytes` is what the mode reads besides the rows (the indices,
    the wire scalars and key rows, or the nibbles and row bases)."""
    import torch

    streams = idx if isinstance(idx, list) else [idx]
    batch = streams[0].shape[1]
    madds = sum(t.numel() for t in streams)
    distinct = sum(torch.unique(t).numel() for t in streams)
    nbytes = input_bytes + distinct * payload + 4 * 17 * batch * 4
    return {
        **_bound(nbytes, madds * FIELD_MULS_PER_MADD * WIDE_PRODUCTS_PER_MUL, streams[0].device),
        "distinct_rows": distinct,
        "legacy_int32_muls": madds * LEGACY_MULS_PER_MADD,
    }


def tail_bound(batch, device, lane_bytes=TAIL_BYTES_PER_LANE):
    """Least time for the verdict tail: the JAX function's work (batch
    inversion) and bytes (`lane_bytes` a lane: R as wire bytes, or as the
    comb path's limbs). `design_products` is what the kernel spends
    instead: a lane's own chain and two multiplies, each of them (the
    squares too) 100 products spread as 20 over each of the group's 5
    threads, which leaves a square's symmetry unused."""
    chains = -(-batch // CHAIN_WIDTH)
    products = ((batch * TAIL_MULS_PER_LANE + chains * CHAIN_MULS) * WIDE_PRODUCTS_PER_MUL
                + chains * CHAIN_SQUARES * SQ_PRODUCTS)
    return {
        **_bound(batch * lane_bytes, products, device),
        "design_products": batch * (CHAIN_SQUARES + CHAIN_MULS + 2) * WIDE_PRODUCTS_PER_MUL,
    }


def canonical_point(p):
    """(4·17, B) or (4, 17, B) -> (4, 17, B) with canonical coordinates."""
    from simple_pbft_tpu_torch.ops import field25519 as fe

    p = p.reshape(4, 17, -1)
    return fe.to_canonical(p.transpose(0, 1)).transpose(0, 1)


def phase_field():
    """The headers' arithmetic on the card against ops/field25519.py: one
    thread an element (ops 0-5) and a group of 5 (the coop_* ops)."""
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
             "invert": lambda: fe.invert(a), "canonical": lambda: a,
             "pow22523": lambda: fe.pow22523(a), "neg": lambda: fe.neg(a),
             "coop_mul": lambda: fe.mul(a, b), "coop_sq": lambda: fe.mul(a, a),
             "coop_invert": lambda: fe.invert(a), "coop_pow22523": lambda: fe.pow22523(a)}
    rows = {}
    for op, fn in plain.items():
        got = comb.encode_kernel.field_op(op, a, b)
        want = fe.to_canonical(fn())
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"field header {op} != ops/field25519.py")
        rows[op] = {"n": a.shape[1], "equal": True}
    rows.update(_point_ops(limbs, rng))
    emit("field", edge_values=len(edge), **rows)


def _point_ops(limbs, rng):
    """K9's point operations on the card (5 threads a point, its test
    entry) against ops/edwards.py, exactly in canonical limbs: the
    doubling and the cached addition on curve points with Z != 1 and on
    random elements, the decompression (and its ok flags) of the same
    y values, edge values among them, with random signs."""
    import numpy as np
    import torch

    from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
    from simple_pbft_tpu_torch.ops import edwards as ed
    from simple_pbft_tpu_torch.ops import field25519 as fe
    from simple_pbft_tpu_torch.ops import ladder

    # point b's coordinates are elements 4b .. 4b + 3: the edge values
    # fall in the first points' coordinates, y among them
    n = limbs.shape[1] // 4 * 4
    pts = limbs[:, :n].reshape(17, n // 4, 4).transpose(2, 0, 1).reshape(4 * 17, n // 4)
    curve = np.stack([np.concatenate([fe._int_to_limbs_np(c * (i + 7) % fe.P_INT)
                                      for c in ref.point_mul(i + 2, ref.B)])
                      for i in range(64)], axis=1)
    p = torch.from_numpy(np.concatenate([curve, pts], axis=1).astype(np.int32)).cuda()
    p = p.contiguous()
    q = p.flip(1).contiguous()
    sign = torch.from_numpy(rng.integers(0, 2, p.shape[1]).astype(np.int32)).cuda()
    pt, qt = p.reshape(4, 17, -1), q.reshape(4, 17, -1)
    plain = {"point_double": lambda: (ed.point_double(pt), None),
             "point_add": lambda: (ed.point_add(pt, qt), None),
             "point_decompress": lambda: ed.decompress(pt[1], sign)}
    rows = {}
    for op, fn in plain.items():
        got, ok = ladder.ladder_kernel.point_op(op.split("_")[1], p, q, sign)
        want, want_ok = fn()
        torch.cuda.synchronize()
        check(torch.equal(got.reshape(4, 17, -1), canonical_point(want))
              and (bool(ok.all()) if want_ok is None else torch.equal(ok, want_ok)),
              f"K9 {op} != ops/edwards.py")
        rows[op] = {"n": p.shape[1], "equal": True,
                    **({"ok": int(ok.sum())} if want_ok is not None else {})}
    return rows


def parts_sweep_ms(wire, a_idx, f_flat, wbits=4):
    """K1 in wire mode at every P, through the library's C entry (these
    launches are outside the wrapper and its count): how the wrapper's
    choice of P compares. The rows' layout is the active one; P need not
    divide the positions."""
    import torch

    from simple_pbft_tpu_torch.ops import comb

    lib = comb.accumulate_kernel.library()
    batch = wire.shape[0]
    out = torch.empty((4 * 17, batch), dtype=torch.int32, device=wire.device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(log2_parts):
        rc = lib.fused_accumulate_launch(
            comb.accumulate_kernel.MODES["wire"], int(comb.PACKED), None, wire.data_ptr(),
            a_idx.data_ptr(), None, None, f_flat.data_ptr(), f_flat.shape[0], None, 0,
            out.data_ptr(), comb.npos_for(wbits), batch, log2_parts, wbits, stream)
        check(rc == 0, f"sweep launch failed: {rc}")

    return {str(1 << lp): cuda_ms(lambda: launch(lp), 10, 2) for lp in range(5)}


def phase_kernel():
    import numpy as np
    import torch

    from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
    from simple_pbft_tpu_torch.crypto.gpu_verifier import BUCKETS, KeyBank
    from simple_pbft_tpu_torch.ops import comb

    dev = torch.device("cuda")
    n_keys = 64
    bank = KeyBank(initial_capacity=n_keys, device=dev, mode="fused")
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
        wire, pre, ok, err_tail = _verdict_check(acc, wire, rng)
        p = acc.reshape(4, 17, batch)
        r_y, r_sign = comb.r_from_wire(wire)
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
                "back_to_back_ms": cuda_ms(lambda: comb.encode_kernel(acc, wire, pre), 5, 3,
                                           BACK_TO_BACK),
                "plain_ms": cuda_ms(lambda: comb.encode_and_compare_plain(
                    p, r_y, r_sign, pre), 2, 1),
                **tail_bound(batch, dev),
            },
        }
    # the verdict kernel at sizes that leave a partial group, warp and block
    partial = {}
    for batch in PARTIAL_BATCHES:
        wire = torch.from_numpy(rng.integers(0, 256, (batch, 96), dtype=np.uint8)).to(dev)
        a_idx = torch.from_numpy(rng.integers(0, n_keys, batch).astype(np.int32)).to(dev)
        acc = k1.wire(wire, a_idx, f_flat)
        wire, pre, ok, err_tail = _verdict_check(acc, wire, rng)
        partial[str(batch)] = {
            "max_abs_err": err_tail, "matches": int(ok.sum()),
            "kernel_ms": cuda_ms(lambda: comb.encode_kernel(acc, wire, pre), 20, 3),
            "back_to_back_ms": cuda_ms(lambda: comb.encode_kernel(acc, wire, pre), 5, 3,
                                       BACK_TO_BACK),
        }
    emit("kernel", keys=n_keys, resident_threads=k1.resident_threads(dev),
         launches_in_phase={"fused_accumulate": k1.launches,
                            "encode_verdict": comb.encode_kernel.launches},
         by_batch={str(b): v for b, v in rows.items()}, verdict_partial=partial)
    return rows


def _verdict_check(acc, wire, rng):
    """The verdict kernel against encode_and_compare_plain on K1's
    (4·17, B) accumulator, with every fourth lane's R its own point's
    encoding (and its precheck true) and 9 in 10 prechecks true elsewhere:
    exact in verdicts and canonical affine limbs, and some lane matched.
    -> (the wire with those R, precheck, verdicts, max abs error)."""
    import numpy as np
    import torch

    from simple_pbft_tpu_torch.ops import comb
    from simple_pbft_tpu_torch.ops import field25519 as fe

    batch = wire.shape[0]
    pre = torch.from_numpy(rng.random(batch) < 0.9).to(wire.device)
    p = acc.reshape(4, 17, batch)
    _, xy = comb.encode_and_compare_plain(p, *comb.r_from_wire(wire), pre, affine=True)
    xy = xy.cpu().numpy()
    wire_np = wire.cpu().numpy()
    for lane in range(0, batch, 4):
        x = fe._limbs_to_int_np(xy[:17, lane:lane + 1])
        y = fe._limbs_to_int_np(xy[17:, lane:lane + 1])
        wire_np[lane, 64:] = np.frombuffer((y | (x & 1) << 255).to_bytes(32, "little"),
                                           np.uint8)
    wire = torch.from_numpy(wire_np).to(wire.device)
    pre[0::4] = True
    want_ok, want_xy = comb.encode_and_compare_plain(p, *comb.r_from_wire(wire), pre,
                                                     affine=True)
    ok, got_xy = comb.encode_kernel(acc, wire, pre, affine=True)
    torch.cuda.synchronize()
    err = int((got_xy.long() - want_xy.long()).abs().max().item())
    check(torch.equal(ok, want_ok) and err == 0, f"verdict kernel != plain at B={batch}")
    check(int(ok.sum()) > 0, f"no lane matched at B={batch}")
    return wire, pre, ok, err


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


_POPULATIONS = {}


def _population(name):
    """One key population's 8,192-item batch: 1,024 signed messages tiled
    8x with 200 seeded corruptions, and the CPU oracle's bitmap. "config3"
    is BASELINE config 3's n = 64 committee and 64 clients (128 keys);
    "bench16" the bench's 16 signers (BASELINE config 2). Signed once a
    run. -> (pubkeys, items, bad positions, oracle, sign_s)."""
    if name not in _POPULATIONS:
        import numpy as np

        from simple_pbft_tpu_torch.config import make_test_committee
        from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
        from simple_pbft_tpu_torch.crypto.verifier import (
            BatchItem,
            kernel_equivalent_cpu_verifier,
        )

        if name == "config3":
            _, keys = make_test_committee(n=64, clients=64)
            signers = [(kp.pub, kp.seed) for _, kp in sorted(keys.items())]
            tag = b"chip smoke vote %d"
        else:
            signers = [(ref.public_key(bytes([i]) * 32), bytes([i]) * 32) for i in range(16)]
            tag = b"bench vote %d"
        t0 = time.perf_counter()
        signed = []
        for i in range(1024):
            pub, seed = signers[i % len(signers)]
            msg = tag % i
            signed.append(BatchItem(pub, msg, ref.sign(seed, msg)))
        sign_s = time.perf_counter() - t0
        items, bad = _corrupt(signed * 8, np.random.default_rng(7), 200)
        oracle = kernel_equivalent_cpu_verifier().verify_batch(items)
        check(sum(oracle) == len(items) - len(bad), "oracle rejected an honest item")
        _POPULATIONS[name] = ([p for p, _ in signers], items, bad, oracle, sign_s)
    return _POPULATIONS[name]


# batch sizes of the kernel phase's extra verdict check: 7 = one warp's 6
# lanes and 1, 8193 = 341 blocks of 24 lanes and 9
PARTIAL_BATCHES = (7, 8193)
# calls a timing of the verdict kernel's back-to-back launches spans
BACK_TO_BACK = 50

# (mode, window bits, packed rows): the accumulate kernel's configurations,
# then the ladder mode's, which runs K9 alone
MODE_CONFIGS = [("fused", w, packed) for w in (4, 5, 6) for packed in (False, True)]
MODE_CONFIGS += [("comb", 4, False), ("ladder", 4, False)]
MODE_BATCHES = (8, 512, 8192)


def _register(verifier, pubkeys):
    """Build the population's tables on 8 threads (the native table build
    runs outside the GIL); the bank's lookup is thread-safe."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(verifier._bank.lookup, pubkeys))


def _max_err(got, want):
    return int((got.reshape(want.shape).long() - want.long()).abs().max().item())


def _mode_kernels(mode, wbits, verifier, seed):
    """K1 (and for comb the verdict kernel's limb entry) against the plain
    versions at every batch of MODE_BATCHES on the verifier's tables,
    exactly in canonical limbs; times and bounds at the largest."""
    import numpy as np
    import torch

    from simple_pbft_tpu_torch.ops import comb

    dev = verifier.device
    k1 = comb.accumulate_kernel
    tables = verifier._bank.device_tables()
    n_keys = len(verifier._bank._index)
    payload = PACKED_PAYLOAD_BYTES if comb.PACKED else ROW_PAYLOAD_BYTES
    npos = comb.NPOS if mode == "comb" else comb.npos_for(wbits)
    rng = np.random.default_rng(seed)
    rows = {}
    for batch in MODE_BATCHES:
        parts = k1.parts_for(batch, dev, npos)
        keys = torch.from_numpy(rng.integers(0, n_keys, batch).astype(np.int32)).to(dev)
        row = {"parts": parts}
        if mode == "fused":
            wire_np = rng.integers(0, 256, (batch, 96), dtype=np.uint8)
            wire_np[0, :64] = 0xFF  # byte 32 of S and of k set: the top window's cut
            wire = torch.from_numpy(wire_np).to(dev)
            idx = comb.wire_index_plain(wire, keys, 1 << wbits)
            want = canonical_point(comb.madd_loop_plain(idx, tables, parts=parts))
            got_w = k1.wire(wire, keys, tables, window=1 << wbits)
            got_i = k1(idx.contiguous(), tables)
            torch.cuda.synchronize()
            row["wire"] = {"max_abs_err": _max_err(got_w, want)}
            row["index"] = {"max_abs_err": _max_err(got_i, want)}
            check(row["wire"]["max_abs_err"] == 0 and row["index"]["max_abs_err"] == 0,
                  f"{verifier.config}: K1 != plain at B={batch}: {row}")
            if batch == MODE_BATCHES[-1]:
                row["wire"].update(
                    kernel_ms=cuda_ms(lambda: k1.wire(wire, keys, tables, window=1 << wbits),
                                      20, 3),
                    plain_ms=cuda_ms(lambda: comb.madd_loop_plain(
                        comb.wire_index_plain(wire, keys, 1 << wbits), tables, parts=parts),
                        2, 1),
                    **accumulate_bound(idx, batch * (64 + 4), payload),
                    parts_sweep_ms=parts_sweep_ms(wire, keys, tables, wbits))
                row["index"].update(
                    kernel_ms=cuda_ms(lambda: k1(idx, tables), 20, 3),
                    plain_ms=cuda_ms(lambda: comb.madd_loop_plain(idx, tables, parts=parts),
                                     2, 1),
                    **accumulate_bound(idx, idx.numel() * 4, payload))
            rows[batch] = row
            continue
        b_flat = comb.base_table_device(dev)
        s = torch.from_numpy(rng.integers(0, 16, (comb.NPOS, batch), dtype=np.int32)).to(dev)
        k = torch.from_numpy(rng.integers(0, 16, (comb.NPOS, batch), dtype=np.int32)).to(dev)
        base = keys * (comb.NPOS * comb.WINDOW)
        want = canonical_point(comb.comb_accumulate_plain(s, k, base, tables, b_flat,
                                                          parts=parts))
        acc = k1.comb(s, k, base, tables, b_flat)
        torch.cuda.synchronize()
        row["comb"] = {"max_abs_err": _max_err(acc, want)}
        check(row["comb"]["max_abs_err"] == 0, f"comb: K1 != plain at B={batch}")
        # the limb entry: every fourth lane's R is its own point's encoding
        p = acc.reshape(4, 17, batch)
        r_y = torch.from_numpy(rng.integers(0, 1 << 15, (17, batch), dtype=np.int32)).to(dev)
        r_sign = torch.from_numpy(rng.integers(0, 2, batch).astype(np.int32)).to(dev)
        pre = torch.from_numpy(rng.random(batch) < 0.9).to(dev)
        _, xy = comb.encode_and_compare_plain(p, r_y, r_sign, pre, affine=True)
        r_y[:, 0::4] = xy[17:, 0::4]
        r_sign[0::4] = xy[0, 0::4] & 1
        pre[0::4] = True
        want_ok, want_xy = comb.encode_and_compare_plain(p, r_y, r_sign, pre, affine=True)
        ok, got_xy = comb.encode_kernel.limbs(acc, r_y, r_sign, pre, affine=True)
        torch.cuda.synchronize()
        row["verdict_limbs"] = {"max_abs_err": _max_err(got_xy, want_xy),
                                "matches": int(ok.sum())}
        check(torch.equal(ok, want_ok) and row["verdict_limbs"]["max_abs_err"] == 0
              and int(ok.sum()) > 0, f"comb: verdict limb entry != plain at B={batch}")
        if batch == MODE_BATCHES[-1]:
            row["comb"].update(
                kernel_ms=cuda_ms(lambda: k1.comb(s, k, base, tables, b_flat), 20, 3),
                plain_ms=cuda_ms(lambda: comb.comb_accumulate_plain(
                    s, k, base, tables, b_flat, parts=parts), 2, 1),
                **accumulate_bound(list(comb.comb_index(s, k, base)),
                                   batch * (2 * comb.NPOS * 4 + 4), payload))
            row["verdict_limbs"].update(
                kernel_ms=cuda_ms(lambda: comb.encode_kernel.limbs(acc, r_y, r_sign, pre),
                                  20, 3),
                back_to_back_ms=cuda_ms(lambda: comb.encode_kernel.limbs(acc, r_y, r_sign, pre),
                                        5, 3, BACK_TO_BACK),
                plain_ms=cuda_ms(lambda: comb.encode_and_compare_plain(p, r_y, r_sign, pre),
                                 2, 1),
                **tail_bound(batch, dev, LIMB_TAIL_BYTES_PER_LANE))
        rows[batch] = row
    return rows


def _ladder_check(items, what):
    """K9 against verify_kernel_plain on the staged items: verdicts and
    canonical affine accumulators exactly. -> (row, device arrays)."""
    import torch

    from simple_pbft_tpu_torch.crypto import gpu_verifier as gv
    from simple_pbft_tpu_torch.ops import ladder

    arrays = [torch.from_numpy(a).to("cuda") for a in gv.prepare_batch(items).arrays()]
    ok, xy = ladder.ladder_kernel(*arrays, affine=True)
    want_ok, want_xy = ladder.verify_kernel_plain(*arrays, affine=True)
    torch.cuda.synchronize()
    row = {"batch": len(items), "max_abs_err": _max_err(xy, want_xy),
           "verdicts_equal": bool(torch.equal(ok, want_ok)), "accepted": int(ok.sum())}
    check(row["verdicts_equal"] and row["max_abs_err"] == 0,
          f"ladder: K9 != verify_kernel_plain ({what}): {row}")
    return row, arrays


# torch.profiler on the H100 now and then gives a short window's trace
# with no device event at all, not even the copies the work must make (it
# lost a whole one-pass trace of the verifier phase once): the tracer's
# loss, not the work's. Such a trace is taken again, and each window is
# padded with idle host time on both sides
TRACE_TRIES, TRACE_PAD_S = 3, 0.01


def _device_events(fn):
    """fn(), which must run work on the card, under torch.profiler ->
    (the trace's device events, the traces taken). A trace that holds no
    device event is taken again, up to TRACE_TRIES traces in all; a trace
    that holds any is returned as it is, for the caller to judge."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for tries in range(1, TRACE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events, tries
    raise AssertionError(f"{TRACE_TRIES} traces in a row held no device event")


def _kernel_us(fn, name, calls=5):
    """torch.profiler's device time of the kernel `name` over `calls`
    calls of fn, median in us."""
    fn()
    events, _ = _device_events(lambda: [fn() for _ in range(calls)])
    us = [e.time_range.elapsed_us() for e in events if name in e.name]
    check(len(us) == calls, f"profiler saw {len(us)} launches of {name}, not {calls}")
    return statistics.median(us)


def _ladder_kernels(population):
    """K9 against its plain version at every batch of MODE_BATCHES and of
    PARTIAL_BATCHES (a partial group, warp and block) on the population's
    items, corrupted ones first, and on the adversarial batch; at each
    batch its time over 50 back-to-back calls; times, bounds and
    registers at the largest, and K9's time at every bucket. -> (rows,
    the staged arrays at the largest batch)."""
    import torch

    from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
    from simple_pbft_tpu_torch.crypto import gpu_verifier as gv
    from simple_pbft_tpu_torch.crypto.adversarial import ladder_adversarial_items
    from simple_pbft_tpu_torch.crypto.gpu_verifier import BUCKETS
    from simple_pbft_tpu_torch.ops import ladder

    _, items, bad, _, _ = _population(population)
    badset = set(bad)
    rows = {}
    for batch in sorted(MODE_BATCHES + PARTIAL_BATCHES):
        order = bad[: batch // 4] + [i for i in range(len(items)) if i not in badset]
        row, staged = _ladder_check([items[order[i % len(order)]] for i in range(batch)],
                                    f"B={batch}")
        row["back_to_back_ms"] = cuda_ms(lambda: ladder.ladder_kernel(*staged), 5, 3,
                                         BACK_TO_BACK)
        rows[batch] = {"ladder": row}
        if batch == MODE_BATCHES[-1]:
            top, arrays = row, staged
    row = top
    row["kernel_ms"] = cuda_ms(lambda: ladder.ladder_kernel(*arrays), 10, 2)
    # the plain version runs for seconds at B = 8192, and the check above
    # has warmed it: one timed run
    row["plain_ms"] = cuda_ms(lambda: ladder.verify_kernel_plain(*arrays), 1, 0)
    row.update(_bound(MODE_BATCHES[-1] * LADDER_BYTES_PER_LANE,
                      MODE_BATCHES[-1] * LADDER_PRODUCTS_PER_LANE, arrays[0].device))
    row["design_products"] = (MODE_BATCHES[-1] * LADDER_DESIGN_MULS_PER_LANE
                              * WIDE_PRODUCTS_PER_MUL)
    named = ladder_adversarial_items()
    adv, _ = _ladder_check([it for _, it in named], "adversarial")
    oracle = [ref.verify(it.pubkey, it.msg, it.sig) for _, it in named]
    got = gv.GpuVerifier(mode="ladder").verify_batch([it for _, it in named])
    check(got == oracle, f"ladder: adversarial bitmap {got} != oracle {oracle}")
    adv["rows"] = {name: ok for (name, _), ok in zip(named, got)}
    rows["adversarial"] = {"ladder": adv}
    # ptxas's report for K9's entry: the lines after its "Compiling entry
    # function" line, up to the next entry's
    entry, row["ptxas"] = False, []
    for ln in ladder.ladder_kernel.build_log.splitlines():
        if "Compiling entry function" in ln:
            entry = "ladder_verify_kernel" in ln
        elif entry and ("registers" in ln or "spill" in ln):
            row["ptxas"].append(ln.strip())
    spills = [ln for ln in row["ptxas"] if "spill" in ln]
    check(spills and all("0 bytes spill stores, 0 bytes spill loads" in ln for ln in spills),
          f"K9: no spill report, or spills: {row['ptxas']}")
    # K9's time at every bucket: how far one lane's chain sets it
    row["ms_by_bucket"] = {}
    for batch in BUCKETS:
        staged = [torch.from_numpy(a).to("cuda")
                  for a in gv.prepare_batch(items[:batch]).arrays()]
        row["ms_by_bucket"][str(batch)] = cuda_ms(lambda: ladder.ladder_kernel(*staged), 5, 1)
    return rows, arrays


def _mode_drive(verifier, population):
    """The configuration's path: GpuVerifier.verify_batch on the
    population's 8,192 items, once for the bitmap and three times more
    for e2e, with the kernels' counts set to 0 just before and read just
    after; the bitmap must equal the oracle's and every call must launch
    K1 in this configuration and the verdict kernel once."""
    import torch

    from simple_pbft_tpu_torch.ops import comb, ladder

    _, items, bad, oracle, _ = _population(population)
    kernels = {"fused_accumulate": comb.accumulate_kernel, "encode_verdict": comb.encode_kernel,
               "ladder_verify": ladder.ladder_kernel}
    if verifier.config == "ladder":
        want = {"fused_accumulate": {}, "encode_verdict": {}, "ladder_verify": {"ladder_verify": 4}}
    else:
        entry = "limbs" if verifier.config.startswith("comb") else "wire"
        want = {"fused_accumulate": {verifier.config: 4}, "encode_verdict": {entry: 4},
                "ladder_verify": {}}
    for k in kernels.values():
        k.reset_counts()
    got = verifier.verify_batch(items)
    e2e = []
    for _ in range(3):
        t0 = time.perf_counter()
        verifier.verify_batch(items)
        e2e.append(time.perf_counter() - t0)
    launches = {name: dict(k.launches_by) for name, k in kernels.items()}
    mismatch = [i for i, (a, b) in enumerate(zip(got, oracle)) if a != b]
    check(not mismatch, f"{verifier.config}: bitmap != oracle at {mismatch[:10]}")
    check(launches == want, f"{verifier.config}: launches {launches}, not {want} "
          f"for 4 verifies")
    t0 = time.perf_counter()
    prep, _ = verifier.prepare(items)
    prep_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays = [torch.from_numpy(a).to(verifier.device) for a in prep.arrays()]
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    tables = verifier._bank.device_tables() if verifier._bank is not None else None
    return {
        "batch": len(items), "corrupted": len(bad), "matches_oracle": True,
        "launches": launches, "verifies_per_s_e2e": len(items) / statistics.median(e2e),
        "host_prep_s": prep_s, "upload_bytes": sum(a.nbytes for a in prep.arrays()),
        "upload_s": upload_s,
        "device_pass_ms": cuda_ms(lambda: verifier.device_pass(arrays, tables), 5),
    }


def phase_modes():
    """Every configuration of the accumulate kernel: K1 against its plain
    version, then a GpuVerifier in that configuration on an 8,192-item
    batch; then the same for the ladder mode and K9. -> {config: row},
    each row's `drive` holding the launches of its verifier drive."""
    import torch

    from simple_pbft_tpu_torch.crypto.gpu_verifier import GpuVerifier
    from simple_pbft_tpu_torch.ops import comb, ladder

    out = {}
    for n, (mode, wbits, packed) in enumerate(MODE_CONFIGS):
        t_config = time.perf_counter()
        name = ("ladder" if mode == "ladder" else
                comb.config_name(mode, wbits, comb.ROW_PACKED if packed else comb.ROW_DENSE))
        population = "bench16" if wbits == 6 else "config3"
        pubkeys = _population(population)[0]
        comb.use_row_packing(packed)
        try:
            t0 = time.perf_counter()
            v = GpuVerifier(mode=mode, window=wbits,
                            initial_keys=len(pubkeys) + (0 if wbits == 6 else 32))
            bank = v._bank
            if bank is not None:
                _register(v, pubkeys)
            v.warm_for_population(pubkeys, max_sweep=8192)
            build_s = time.perf_counter() - t0
            if bank is not None:
                check(len(bank._index) == len(pubkeys), f"{v.config}: bank holds "
                      f"{len(bank._index)} of {len(pubkeys)} keys")
                kernels = _mode_kernels(mode, wbits, v, 4000 + n)
            else:
                kernels, staged = _ladder_kernels(population)
            drive = _mode_drive(v, population)
            if bank is None:
                # K9's time by the profiler, after the drive: a profiler
                # session ahead of it could slow the drive's host path
                kernels[MODE_BATCHES[-1]]["ladder"]["profiler_us"] = _kernel_us(
                    lambda: ladder.ladder_kernel(*staged), "ladder_verify_kernel")
            row = {"mode": mode, "window": wbits, "rowpack": packed,
                   "population": population,
                   "bank_keys": len(bank._index) if bank else 0,
                   "bank_capacity": bank._cap if bank else 0,
                   "bank_bytes": bank._np.nbytes if bank else 0,
                   "max_keys": bank._max_keys if bank else None, "build_and_warm_s": build_s,
                   "by_batch": {str(b): r for b, r in kernels.items()}, "drive": drive}
            check(v.config == name, f"{v.config} built for {name}")
            out[name] = row
            del v
            torch.cuda.empty_cache()
        finally:
            comb.use_row_packing(False)
        row["seconds"] = time.perf_counter() - t_config
        emit("modes", config=name, **row)
    return out


# the mesh phase's sizes: BASELINE config 3 (a committee of 64 with prepare
# and commit quorum batching), its 8,192-item batch as 128 instances of 64
# votes, on a mesh of 4 positions of the one card
MESH_INST, MESH_VOTES, MESH_K = 128, 64, 4
# 2048 and 2 are the shard shapes the mesh of 4 gives the kernel: B / MESH_K,
# and the dry run's 2 votes a position; 33 a partial row block. n_inst 4
# and 128 take the 16-byte loads on an aligned base, the others (and a
# base 4 bytes off) the scalar path
TALLY_BATCHES = (1, 2, 7, 8, 33, 512, MESH_INST * MESH_VOTES // MESH_K, 8192, 8193)
TALLY_INSTANCES = (1, 2, 3, 4, 128, 130, 1000)
TALLY_BASES = {"aligned": 0, "offset": 1}  # int32 elements before the one-hot
TALLY_TOP = (8192, 128)
HOST_CALLS = 2000  # unsynchronised wrapper calls timed for its host time


def tally_bound(onehot, verdict):
    """Least time for the tally on this input: the verdicts read once, the
    one-hot rows of the votes whose verdict is set read once (no other row
    adds to a count), the counts written once; one add an element read."""
    batch, n_inst = onehot.shape
    n_valid = int(verdict.sum())
    return {"n_valid": n_valid,
            **_bound(n_valid * n_inst * 4 + batch + n_inst * 4, n_valid * n_inst,
                     onehot.device)}


def _path_kernels():
    from simple_pbft_tpu_torch.ops import comb, ladder, quorum

    return {"fused_accumulate": comb.accumulate_kernel, "encode_verdict": comb.encode_kernel,
            "ladder_verify": ladder.ladder_kernel, "quorum_tally": quorum.tally_kernel}


class _Counted:
    """Launches of the mesh path's drives: each drive runs with every
    kernel's count set to 0 just before it and is read just after; the
    totals sum the drives'."""

    def __init__(self):
        self.total = {k: 0 for k in _path_kernels()}
        self.entries = {"wire": 0, "limbs": 0}

    def __call__(self, fn):
        import torch

        kernels = _path_kernels()
        for k in kernels.values():
            k.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {name: k.launches for name, k in kernels.items()}
        for name, n in got.items():
            self.total[name] += n
        for entry in self.entries:
            self.entries[entry] += kernels["encode_verdict"].launches_by.get(entry, 0)
        return out, got


def _tally_onehot(rows, base):
    """`rows` on the card, contiguous, `TALLY_BASES[base]` int32 elements
    past the start of its buffer (16-byte aligned at 0, 4 bytes off at 1)."""
    import torch

    skip = TALLY_BASES[base]
    buf = torch.empty(rows.size + skip, dtype=torch.int32, device="cuda")
    t = buf[skip:].view(rows.shape)
    t.copy_(torch.from_numpy(rows))
    return t


def _host_us(fn, calls=HOST_CALLS):
    """Median host time of one unsynchronised call of fn, in us."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def _tally_library(onehot, verdict):
    """The one PyTorch call that could compute the tally, torch.mv of the
    one-hot's transpose by the verdicts in int32 -> its ms where it runs
    and agrees with the plain version, else None and why."""
    import torch

    from simple_pbft_tpu_torch.ops import quorum

    flags = verdict.to(torch.int32)
    try:
        got = torch.mv(onehot.t(), flags)
        torch.cuda.synchronize()
    except RuntimeError as e:  # the yardstick only: the port never calls it
        return None, f"torch.mv in int32 on CUDA raises: {str(e).splitlines()[0]}"
    if not torch.equal(got, quorum.quorum_tally_plain(onehot, verdict)):
        return None, "torch.mv in int32 on CUDA runs but disagrees with the plain version"
    return cuda_ms(lambda: torch.mv(onehot.t(), flags), 20, 3), "torch.mv(onehot.t(), verdict)"


def _mesh_tally():
    """(a) The tally kernel against quorum_tally_plain, exactly, at every B
    and n_inst of the grid, on both load paths (an aligned base and one 4
    bytes off), with all-zero padding rows, added into a nonzero `out`;
    random weights that wrap at B = 8192, n_inst = 128. Then at that shape
    on each path: one call and back-to-back times by CUDA events, the
    profiler's kernel time and the wrapper's host time, with `out=` as the
    quorum step calls it (and without, which zeroes a fresh vector); the
    plain version's time, the library call's and the bound."""
    import numpy as np
    import torch

    from simple_pbft_tpu_torch.ops import quorum

    rng = np.random.default_rng(11)
    errs, paths = {}, {"vec4": 0, "scalar": 0}
    for batch in TALLY_BATCHES:
        for n_inst in TALLY_INSTANCES:
            rows = np.eye(n_inst, dtype=np.int32)[rng.integers(0, n_inst, batch)]
            rows[::7] = 0  # padding rows
            verdict = torch.from_numpy(rng.random(batch) < 0.9).to("cuda")
            start = rng.integers(-2**31, 2**31, n_inst, dtype=np.int64).astype(np.int32)
            for base in TALLY_BASES:
                onehot = _tally_onehot(rows, base)
                vec = quorum.vector_path(onehot)
                check(vec == (base == "aligned" and n_inst % 4 == 0),
                      f"tally path at {batch}x{n_inst} {base}: vec4={vec}")
                paths["vec4" if vec else "scalar"] += 1
                out = torch.from_numpy(start).to("cuda")
                quorum.tally_kernel(onehot, verdict, out=out)
                want = (torch.from_numpy(start).to("cuda").long()
                        + quorum.quorum_tally_plain(onehot, verdict).long()).to(torch.int32)
                torch.cuda.synchronize()
                errs[f"{batch}x{n_inst}_{base}"] = _max_err(out, want)
                check(torch.equal(out, want),
                      f"quorum_tally != plain at B={batch}, n_inst={n_inst}, {base}")
    batch, n_inst = TALLY_TOP
    verdict = torch.from_numpy(rng.random(batch) < 0.9).to("cuda")
    weights = rng.integers(-2**31, 2**31, (batch, n_inst), dtype=np.int64).astype(np.int32)
    rows = np.eye(n_inst, dtype=np.int32)[rng.integers(0, n_inst, batch)]
    rows[::7] = 0
    for base in TALLY_BASES:
        w = _tally_onehot(weights, base)
        got = quorum.tally_kernel(w, verdict)
        want = quorum.quorum_tally_plain(w, verdict)
        torch.cuda.synchronize()
        errs[f"weights_{base}"] = _max_err(got, want)
        check(torch.equal(got, want), f"quorum_tally != plain on wrapping weights, {base}")
    by_path = {}
    for base, path in (("aligned", "vec4"), ("offset", "scalar")):
        onehot = _tally_onehot(rows, base)
        out = torch.zeros(n_inst, dtype=torch.int32, device="cuda")

        def call():
            return quorum.tally_kernel(onehot, verdict, out=out)

        by_path[path] = {
            "kernel_ms": cuda_ms(call, 20, 3),
            "back_to_back_ms": cuda_ms(call, 5, 3, BACK_TO_BACK),
            "host_us": _host_us(call),
            "host_us_fresh_out": _host_us(lambda: quorum.tally_kernel(onehot, verdict)),
            # the kernel alone: the wrapper's host time exceeds the
            # kernel's, so neither CUDA-event timing shows it
            "profiler_us": _kernel_us(call, "quorum_tally_kernel"),
        }
    onehot = _tally_onehot(rows, "aligned")
    library_ms, library = _tally_library(onehot, verdict)
    # the least a kernel takes: the fill that zeroes a step's counts vector
    fill = torch.zeros(n_inst, dtype=torch.int32, device="cuda")
    fill_us = _kernel_us(fill.zero_, "Fill")
    return {
        "max_abs_err": max(errs.values()), "max_abs_err_by_shape": errs,
        "shapes_by_path": paths, "batch": batch, "n_inst": n_inst,
        **by_path["vec4"], "by_path": by_path,
        "plain_ms": cuda_ms(lambda: quorum.quorum_tally_plain(onehot, verdict), 20, 3),
        "library_ms": library_ms, "library": library, "fill_us": fill_us,
        **tally_bound(onehot, verdict),
    }


def _profile_step(step, args, mesh):
    """torch.profiler over one comb quorum step on the mesh of k positions
    over d distinct devices: exactly k launches each of K1, the verdict
    kernel's limb entry and the tally; exactly d zeroings of a counts
    vector (a memset or a fill kernel: the step's one zeroed vector a
    device; the tally kernel zeroes nothing); d - 1 psum adds; k row-base
    multiplies (comb_verify_kernel's); besides those, only copies."""
    k, d = mesh.size, len(mesh.distinct())
    step(*args)
    traced, tries = _device_events(lambda: step(*args))
    events = [e for e in traced if not e.name.startswith("Memcpy")]
    names = ("fused_accumulate_kernel", "encode_verdict_limbs_kernel", "quorum_tally_kernel")
    count = {n: sum(1 for e in events if n in e.name) for n in names}
    others = [e.name for e in events if not any(n in e.name for n in names)]
    zeroings = [n for n in others if n.startswith("Memset") or "fill" in n.lower()]
    memsets = [n for n in zeroings if n.startswith("Memset")]
    others = [n for n in others if n not in zeroings]
    adds = [n for n in others if "add" in n.lower()]
    muls = [n for n in others if "mul" in n.lower()]
    check(all(c == k for c in count.values()) and len(zeroings) == d
          and len(adds) == d - 1 and len(muls) == k
          and len(others) == len(adds) + len(muls),
          f"profiled comb step on {k} positions of {d} devices: {count}, zeroings "
          f"{zeroings}, others {others}")
    return {"kernels": count, "traces": tries, "zeroings": len(zeroings),
            "memsets": len(memsets), "psum_adds": len(adds), "row_base_muls": len(muls),
            "kernel_us": {n: sum(e.time_range.elapsed_us() for e in events if n in e.name)
                          for n in names}}


def phase_mesh():
    """The multi-device path on one card: (a) the tally kernel; (b) both
    quorum steps on Mesh(["cuda:0"] * 4) and on a mesh of 1; (c) meshed
    GpuVerifiers in fused w=4 dense, comb and ladder; (d) the port's
    dryrun_multichip(4); (e) an n = 4 committee sharing one meshed fused
    verifier. -> the path's launches, by kernel and by verdict entry, and
    the tally's row."""
    import numpy as np

    from simple_pbft_tpu_torch.crypto.gpu_verifier import GpuVerifier, prepare_batch
    from simple_pbft_tpu_torch.ops import comb
    from simple_pbft_tpu_torch.parallel import Mesh, make_comb_quorum_step, make_quorum_step
    from simple_pbft_tpu_torch.parallel.dryrun import dryrun_multichip
    from simple_pbft_tpu_torch.parallel.mesh import gather

    counted = _Counted()
    tally = _mesh_tally()
    pubkeys, items, bad, oracle, _ = _population("config3")
    inst = np.arange(len(items)) // MESH_VOTES
    onehot = np.eye(MESH_INST, dtype=np.int32)[inst]
    want_counts = np.bincount(inst, weights=np.asarray(oracle, dtype=np.int64),
                              minlength=MESH_INST).astype(np.int64).tolist()
    meshes = {k: Mesh(["cuda:0"] * k) for k in (1, MESH_K)}
    verifiers = {}
    for k, mesh in meshes.items():
        for mode in ("fused", "comb", "ladder"):
            v = GpuVerifier(mode=mode, initial_keys=len(pubkeys) + 32, mesh=mesh)
            if v._bank is not None:
                _register(v, pubkeys)
            v.warm_for_population(pubkeys, max_sweep=8192)
            verifiers[k, mode] = v

    # (b) the quorum steps, staged by the meshed verifiers' own staging
    comb_v = verifiers[MESH_K, "comb"]
    s_nib, k_nib, a_idx, r_y, r_sign, pre = comb_v.prepare(items)[0].arrays()
    dev = meshes[MESH_K].devices[0]
    comb_args = (s_nib, k_nib, a_idx, comb_v._bank.device_tables(),
                 comb.base_table_device(dev), r_y, r_sign, pre, onehot)
    ladder_args = (*prepare_batch(items).arrays(), onehot)
    steps = {}
    for k, mesh in meshes.items():
        for kind, make, args in (("comb", make_comb_quorum_step, comb_args),
                                 ("ladder", make_quorum_step, ladder_args)):
            step = make(mesh)
            (verdict, counts), launches = counted(lambda: step(*args))
            got = gather(verdict).tolist()
            mismatch = [i for i, (a, b) in enumerate(zip(got, oracle)) if a != b]
            check(not mismatch, f"{kind} step on {k}: verdicts != oracle at {mismatch[:10]}")
            check(len(counts) == k and all(c.cpu().tolist() == want_counts for c in counts),
                  f"{kind} step on {k}: counts != the oracle's tally")
            want = ({"fused_accumulate": k, "encode_verdict": k, "ladder_verify": 0}
                    if kind == "comb" else
                    {"fused_accumulate": 0, "encode_verdict": 0, "ladder_verify": k})
            check(launches == {**want, "quorum_tally": k},
                  f"{kind} step on {k}: launches {launches}")
            row = {"launches": launches, "matches_oracle": True,
                   "step_ms": cuda_ms(lambda: step(*args), 5, 1)}
            if kind == "comb":
                row["profile"] = _profile_step(step, args, mesh)
            steps[f"{kind}_mesh{k}"] = row

    # (c) the meshed verifiers' passes
    passes = {}
    for (k, mode), v in verifiers.items():
        got, launches = counted(lambda: v.verify_batch(items))
        mismatch = [i for i, (a, b) in enumerate(zip(got, oracle)) if a != b]
        check(not mismatch, f"{mode} verifier on {k}: bitmap != oracle at {mismatch[:10]}")
        want = ({"fused_accumulate": 0, "encode_verdict": 0, "ladder_verify": k}
                if mode == "ladder" else
                {"fused_accumulate": k, "encode_verdict": k, "ladder_verify": 0})
        check(launches == {**want, "quorum_tally": 0},
              f"{mode} verifier on {k}: launches {launches} a pass")
        e2e = []
        for _ in range(3):
            t0 = time.perf_counter()
            v.verify_batch(items)
            e2e.append(time.perf_counter() - t0)
        arrays = v.prepare(items)[0].padded(8192).arrays()
        passes[f"{mode}_mesh{k}"] = {
            "launches": launches, "matches_oracle": True,
            "verifies_per_s_e2e": len(items) / statistics.median(e2e),
            "mesh_pass_ms": cuda_ms(lambda: v.mesh_pass(arrays), 5, 1)}

    # (d) the dry run, (e) a committee over one meshed fused verifier
    t0 = time.perf_counter()
    _, dry = counted(lambda: dryrun_multichip(MESH_K))
    dry_s = time.perf_counter() - t0
    check(dry["fused_accumulate"] > 0 and dry["quorum_tally"] == MESH_K,
          f"dry run launches {dry}")
    committee = _mesh_committee(counted)
    emit("mesh", mesh=MESH_K, batch=len(items), n_inst=MESH_INST, votes=MESH_VOTES,
         corrupted=len(bad), tally=tally, steps=steps, verifiers=passes,
         dryrun={"launches": dry, "seconds": dry_s}, committee=committee,
         launches=counted.total, verdict_entries=counted.entries)
    return {"launches": counted.total, "verdict_entries": counted.entries, "tally": tally}


def _mesh_committee(counted):
    """tests/test_committee.py's meshed committee on the card: n = 4, one
    client, `put m1 1` then `get m1`, every replica sharing one fused
    GpuVerifier over Mesh(["cuda:0"] * 4); the consensus traffic must reach
    the mesh beyond the warm, each pass launching both kernels 4 times."""
    import asyncio

    from simple_pbft_tpu_torch.committee import LocalCommittee
    from simple_pbft_tpu_torch.crypto.gpu_verifier import GpuVerifier
    from simple_pbft_tpu_torch.parallel import Mesh

    shared = GpuVerifier(mode="fused", initial_keys=16, mesh=Mesh(["cuda:0"] * MESH_K))
    com = LocalCommittee.build(n=4, clients=1, verifier_factory=lambda: shared,
                               view_timeout=30.0)
    shared.warm(pubkeys=[kp.pub for kp in com.keys.values()], buckets=[8, 32])
    baseline = shared.device_calls

    async def scenario():
        com.start()
        try:
            return [await com.clients[0].submit("put m1 1"),
                    await com.clients[0].submit("get m1")]
        finally:
            await com.stop()

    replies, launches = counted(lambda: asyncio.run(asyncio.wait_for(scenario(), 120)))
    check(replies == ["ok", "1"], f"committee replies {replies}")
    calls = shared.device_calls - baseline
    check(calls > 0, "the committee's traffic never reached the mesh")
    check(launches["fused_accumulate"] == launches["encode_verdict"] == calls * MESH_K,
          f"committee launches {launches} for {calls} passes on {MESH_K}")
    return {"replies": replies, "device_calls": calls, "launches": launches}


def phase_verifier():
    import torch

    from simple_pbft_tpu_torch.crypto.gpu_verifier import GpuVerifier, prepare_wire_batch
    from simple_pbft_tpu_torch.ops import comb

    pubkeys, items, bad, oracle, sign_s = _population("config3")
    t0 = time.perf_counter()
    gpu = GpuVerifier(initial_keys=128 + 32)
    gpu.warm_for_population(pubkeys, max_sweep=8192)
    warm_s = time.perf_counter() - t0
    check(gpu._bank._cap == 256 and len(gpu._bank._index) == 128, "bank shape")
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
    # the rows of this batch (1,024 messages tiled 8 times) that K1 reads
    # more than once come from the L2 cache, not from device memory
    distinct = torch.unique(comb.wire_index_plain(wire, a_idx)).numel()
    return {"batch": len(items), "accumulate_ms": split[0], "distinct_rows": distinct,
            "bank": gpu._bank, "wire": wire, "a_idx": a_idx}


# the gather probe: the rows one fused w=4 pass reads at B = 8192 (64 a
# lane), at random, from a table the size of BASELINE config 3's bank;
# index_select copies element by element, so the same rows are gathered
# as 4-, 8- and 16-byte elements
GATHER_SLOTS, GATHER_BATCH, GATHER_CALLS = 256, 8192, 20
GATHER_VIEWS = (("int32", 4), ("int64", 8), ("complex128", 16))


def gather_probe(row_words, seed):
    """torch.index_select of GATHER_BATCH x 64 random rows of `row_words`
    int32 words from the flattened fused w=4 table of a GATHER_SLOTS-key
    bank, the table viewed in each of GATHER_VIEWS' element types: the
    median of GATHER_CALLS calls by CUDA events and the rows gathered
    (not the copy written) a second, for each view; `gbps` is the
    fastest view's."""
    import torch

    from simple_pbft_tpu_torch.ops import comb

    npos = comb.npos_for(4)
    n_rows = GATHER_SLOTS * npos * comb.FWINDOW
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randint(0, 1 << 30, (n_rows, row_words), dtype=torch.int32,
                          device="cuda", generator=gen)
    idx = torch.randint(0, n_rows, (GATHER_BATCH * npos,), device="cuda", generator=gen)
    gathered = GATHER_BATCH * npos * row_words * 4
    views = {}
    for name, size in GATHER_VIEWS:
        view = table.view(getattr(torch, name))
        check(view.shape == (n_rows, row_words * 4 // size), f"{name} view {view.shape}")
        out = torch.index_select(view, 0, idx)
        check(torch.equal(out[:256].view(torch.int32), table[idx[:256]]),
              f"index_select ({name}) gathered other rows")
        ms = cuda_ms(lambda: torch.index_select(view, 0, idx), GATHER_CALLS)
        views[name] = {"ms": ms, "gbps": gathered / ms / 1e6}
        del out
    del table
    torch.cuda.empty_cache()
    best = max(views, key=lambda k: views[k]["gbps"])
    return {"row_bytes": row_words * 4, "rows": GATHER_BATCH * npos,
            "table_bytes": n_rows * row_words * 4, "gathered_bytes": gathered,
            "calls": GATHER_CALLS, "views": views, "fastest": best,
            "ms": views[best]["ms"], "gbps": views[best]["gbps"]}


def _sign_all(jobs):
    """Ed25519 signatures of (seed, msg) pairs: OpenSSL where the
    `cryptography` wheel is installed, else the RFC 8032 reference on one
    process a core (the pool is gone when this returns)."""
    from concurrent.futures import ProcessPoolExecutor

    from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
    from simple_pbft_tpu_torch.crypto import signer

    if signer._HAVE_OPENSSL:
        return [signer.Signer("", seed).sign(msg) for seed, msg in jobs]
    with ProcessPoolExecutor(os.cpu_count()) as pool:
        return list(pool.map(ref.sign, *zip(*jobs), chunksize=256))


def cold_rows(verifier):
    """K1 on cold rows: 8,192 distinct messages signed by BASELINE config
    3's 128 signers in turn, staged against the verifier phase's bank.
    The pass's bitmap must be all true and K1 must equal its plain version
    in canonical limbs. K1's one-call and back-to-back times on it and on
    the verifier phase's tiled batch (1,024 messages 8 times), in the same
    call, and the distinct rows each gathers."""
    import torch

    from simple_pbft_tpu_torch.config import make_test_committee
    from simple_pbft_tpu_torch.crypto.gpu_verifier import prepare_wire_batch
    from simple_pbft_tpu_torch.crypto.verifier import BatchItem
    from simple_pbft_tpu_torch.ops import comb

    _, keys = make_test_committee(n=64, clients=64)
    signers = [(kp.pub, kp.seed) for _, kp in sorted(keys.items())]
    jobs = [(signers[i % len(signers)][1], b"chip smoke cold %d" % i)
            for i in range(verifier["batch"])]
    t0 = time.perf_counter()
    sigs = _sign_all(jobs)
    sign_s = time.perf_counter() - t0
    items = [BatchItem(signers[i % len(signers)][0], msg, sig)
             for i, ((_, msg), sig) in enumerate(zip(jobs, sigs))]
    bank = verifier["bank"]
    prep, fallback = prepare_wire_batch(items, bank)
    check(not fallback and len(bank._index) == 128, "the cold batch left the bank")
    dev = bank.device_tables().device
    wire, a_idx, pre = (torch.from_numpy(a).to(dev) for a in prep.arrays())
    tables = bank.device_tables()
    ok = comb.fused_verify_wire_kernel(wire, a_idx, tables, pre)
    check(bool(ok.all()), f"the cold batch's pass rejected {int((~ok).sum())} honest items")
    k1 = comb.accumulate_kernel
    widx = comb.wire_index_plain(wire, a_idx)
    got = k1.wire(wire, a_idx, tables)
    want = canonical_point(comb.madd_loop_plain(widx, tables, parts=k1.parts_for(len(items), dev)))
    err = int((canonical_point(got.reshape(4, 17, len(items))).long() - want.long()).abs().max())
    check(err == 0, "K1 != plain on the cold batch")
    out = {"sign_s": sign_s, "max_abs_err": err}
    for name, (w, a) in (("cold", (wire, a_idx)), ("tiled", (verifier["wire"], verifier["a_idx"]))):
        rows = torch.unique(comb.wire_index_plain(w, a)).numel()
        one = cuda_ms(lambda: k1.wire(w, a, tables), 20, 3)
        b2b = cuda_ms(lambda: k1.wire(w, a, tables), 5, 3, BACK_TO_BACK)
        out[name] = {"distinct_rows": rows, "ms": one, "back_to_back_ms": b2b,
                     "distinct_gbps": rows * comb.ROW * 4 / b2b / 1e6}
    return out


def phase_costmodel(verifier):
    """The cost model's roofline join: the card's gather rate (dense and
    packed rows), the model's fused w=4 shape at B = 8192, and the
    verifier phase's K1 time as an achieved gather rate against the
    model's `h100` ceiling; then K1 on cold rows (cold_rows) against the
    same ceiling."""
    from simple_pbft_tpu_torch.crypto import costmodel
    from simple_pbft_tpu_torch.ops import comb

    dense = gather_probe(comb.ROW_DENSE, 1)
    packed = gather_probe(comb.ROW_PACKED, 2)
    cost = costmodel.shape_cost("fused", 4, verifier["batch"])
    check(cost["row_bytes"] == 256 and cost["gather_bytes_per_pass"] == dense["gathered_bytes"],
          f"shape_cost disagrees with the probe's rows: {cost}")
    peak = costmodel.PEAK_GATHER_GBPS["h100"]
    check(dense["gbps"] > 0 and packed["gbps"] > 0 and peak > 0, "no gather rate")
    k1_ms = verifier["accumulate_ms"]
    achieved = cost["gather_bytes_per_pass"] / k1_ms / 1e6
    distinct = verifier["distinct_rows"] * cost["row_bytes"] / k1_ms / 1e6
    cold = cold_rows(verifier)
    for name in ("cold", "tiled"):
        cold[name]["distinct_share_of_peak"] = cold[name]["distinct_gbps"] / peak
    emit("costmodel", gather_dense=dense, gather_packed=packed, shape_cost=cost,
         k1_ms=k1_ms, k1_gather_gbps=achieved, peak_gather_gbps=peak,
         k1_share_of_peak=achieved / peak, k1_share_of_this_probe=achieved / dense["gbps"],
         k1_distinct_rows=verifier["distinct_rows"], k1_distinct_gather_gbps=distinct,
         k1_distinct_share_of_peak=distinct / peak, k1_cold_rows=cold)
    return cold


def profile_pass(prep, tables):
    """torch.profiler over one pass as GpuVerifier dispatches it (host
    arrays up, the pass, verdicts down): the device must run exactly the
    two kernels, besides copies."""
    import torch

    from simple_pbft_tpu_torch.ops import comb

    dev = tables.device

    def one_pass():
        wire, a_idx, pre = (torch.from_numpy(a).to(dev) for a in prep.arrays())
        comb.fused_verify_wire_kernel(wire, a_idx, tables, pre).cpu()

    device_events, tries = _device_events(one_pass)
    copies = [e.name for e in device_events if e.name.startswith(("Memcpy", "Memset"))]
    kernels = [e.name for e in device_events if not e.name.startswith(("Memcpy", "Memset"))]
    check(len(kernels) == 2 and "fused_accumulate_kernel" in kernels[0]
          and "encode_verdict_kernel" in kernels[1],
          f"profiled pass ran {kernels}, not the two kernels")
    return {"kernels": kernels, "copies": len(copies), "traces": tries,
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
        comb.accumulate_kernel.reset_counts()
        comb.encode_kernel.reset_counts()
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


def _json_lines(text, key):
    """The lines of `text` that are JSON objects holding `key`."""
    recs = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if key in rec:
                recs.append(rec)
    return recs


def _last_json(text, key):
    """The last line of `text` that is a JSON object holding `key`."""
    recs = _json_lines(text, key)
    return recs[-1] if recs else None


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
                                       "encode_verdict": v["device_passes"],
                                       "ladder_verify": 0},
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


def _run_json(args, key, timeout, env=None):
    """Run a module of the port, with `env` added to the environment; ->
    its last JSON line holding `key`."""
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout, env={**os.environ, **(env or {})})
    rec = _last_json(proc.stdout, key)
    check(proc.returncode == 0 and rec is not None,
          f"{args[0]} exited {proc.returncode}: {proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    return rec


def _run_sampled(args, key, timeout):
    """Run a module of the port while this process samples the card's used
    memory (mem_get_info, card-wide); -> its JSON lines holding `key`, and
    the most the card held beyond what it held before, in bytes. The
    module's process group is gone when this returns, also on failure."""
    import torch

    free, total = torch.cuda.mem_get_info(0)
    before = total - free
    most = [before]
    done = threading.Event()

    def sample():
        while not done.wait(0.25):
            free, total = torch.cuda.mem_get_info(0)
            most[0] = max(most[0], total - free)

    sampler = threading.Thread(target=sample, daemon=True)
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    sampler.start()
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        done.set()
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        sampler.join(timeout=10)
    recs = _json_lines(out, key)
    check(proc.returncode == 0 and recs,
          f"{args[0]} exited {proc.returncode}: {out[-1500:]} {err[-1500:]}")
    return recs, most[0] - before


# the replica unit at the JAX script's defaults: n = 100 (f = 33), 16
# blocks of 128 requests, modes plain and qc
RU_BLOCKS = 16
RU_KEYS = ("n", "quorum", "blocks", "batch", "wire_messages", "completed_blocks", "req_s",
           "ms_per_req", "elapsed_s", "presign_s", "verify_items", "verify_s", "verify_share",
           "svc_device_passes", "svc_cpu_passes", "svc_rtt_ms_ema", "kernel_launches",
           "bank_keys", "platform")


def phase_replica_unit():
    """python -m simple_pbft_tpu_torch.bench_replica_unit --verifier gpu:
    one replica of n = 100 fed pre-signed traffic, verifying through the
    verify service on the card, in plain and qc mode."""
    t0 = time.perf_counter()
    recs, card_used = _run_sampled(["simple_pbft_tpu_torch.bench_replica_unit",
                                    "--verifier", "gpu"], "bench", 900)
    check([r["mode"] for r in recs] == ["plain", "qc"], f"replica unit modes: {recs}")
    for r in recs:
        check(r["ok"] and r["completed_blocks"] == RU_BLOCKS and r["platform"] == "gpu",
              f"replica unit ({r['mode']}) did not commit every block: {r}")
        check(r["svc_device_passes"] > 0 and all(v > 0 for v in r["kernel_launches"].values()),
              f"replica unit ({r['mode']}) never reached the card: {r}")
    emit("replica_unit", modes={r["mode"]: {k: r.get(k) for k in RU_KEYS} for r in recs},
         card_used_bytes=card_used, wall_s=time.perf_counter() - t0)
    return {k: sum(r["kernel_launches"][k] for r in recs)
            for k in ("fused_accumulate", "encode_verdict")}


# BASELINE config 3: a committee of 64 (f = 21), 8 clients x 128 requests in
# flight (the bench's --outstanding is the total), blocks of up to 256, every
# verify pile on the card (as the committee phase)
CONFIG3_ARGS = ("--configs", "3", "--verifier", "gpu", "--seconds", "10", "--clients", "8",
                "--outstanding", "1024", "--batch", "256", "--verify-cpu-cutoff", "0")
CONFIG3_KEYS = ("config", "n", "clients", "outstanding", "window_s", "committed_req_s",
                "completed_total", "p50_ms", "p99_ms", "client_timeouts", "replica_exec_min",
                "replica_exec_max", "verify_calls", "verify_batch_mean", "verify_ms_mean",
                "svc_device_passes", "svc_device_items", "svc_cpu_passes", "svc_max_coalesced",
                "svc_rtt_ms_ema", "svc_watchdog_failovers", "svc_cpu_reroute_passes",
                "bank_keys", "svc_device_shapes")


def phase_config3():
    """python -m simple_pbft_tpu_torch.bench_consensus --configs 3 --verifier
    gpu: BASELINE config 3 in one process, one shared verifier."""
    t0 = time.perf_counter()
    recs, card_used = _run_sampled(["simple_pbft_tpu_torch.bench_consensus", *CONFIG3_ARGS],
                                   "committed_req_s", 900)
    rec = recs[-1]
    shapes = rec["svc_device_shapes"]
    launches = shapes["kernel_launches_after_warm"]
    check(rec["config"] == "pbft-n64" and rec["n"] == 64 and rec["outstanding"] == 1024,
          f"config 3 ran another shape: {rec['config']}, n {rec['n']}, {rec['outstanding']}")
    check(rec["committed_req_s"] > 0, f"config 3 committed nothing: {rec['committed_req_s']}")
    check(rec["svc_device_passes"] > 0 and rec["svc_cpu_passes"] == 0
          and rec["svc_cpu_reroute_passes"] == 0,
          f"config 3: {rec['svc_device_passes']} device passes, {rec['svc_cpu_passes']} CPU, "
          f"{rec['svc_cpu_reroute_passes']} rerouted")
    check(rec["svc_watchdog_failovers"] == 0 and shapes["post_warm_compiles"] == 0,
          f"config 3 left the device or met a first-time shape: {shapes}")
    check(launches["fused_accumulate"] > 0 and launches["encode_verdict"] > 0
          and launches["ladder_verify"] == 0, f"config 3 launches: {launches}")
    emit("config3", args=list(CONFIG3_ARGS), record={k: rec.get(k) for k in CONFIG3_KEYS},
         card_used_bytes=card_used, wall_s=time.perf_counter() - t0)
    return {k: launches[k] for k in ("fused_accumulate", "encode_verdict")}


# BASELINE config 4 (bls-qc-n256): 256 replicas and 8 clients in one
# process, BLS quorum certificates, every verify pile on the card; 264 keys
# in a fused w=4 bank of 512 slots, the reference's cap
CONFIG4_ARGS = ("--configs", "4", "--verifier", "gpu", "--seconds", "10",
                "--verify-cpu-cutoff", "0")
CONFIG4_KEYS = CONFIG3_KEYS + ("qc_mode", "seconds", "bank_max_keys", "bank_slots",
                               "keys_over_cap", "svc_cpu_items")


def phase_config4():
    """python -m simple_pbft_tpu_torch.bench_consensus --configs 4 --verifier
    gpu --verify-cpu-cutoff 0: BASELINE config 4 in one process under the
    restored bank cap. Every key of the committee and its clients must fit
    the bank (the reference's failure on its chip was client keys over the
    cap), and every pass must be on the card."""
    t0 = time.perf_counter()
    recs, card_used = _run_sampled(["simple_pbft_tpu_torch.bench_consensus", *CONFIG4_ARGS],
                                   "committed_req_s", 900)
    rec = recs[-1]
    wall = time.perf_counter() - t0
    shapes = rec["svc_device_shapes"]
    launches = shapes["kernel_launches_after_warm"]
    emit("config4", args=list(CONFIG4_ARGS), record={k: rec.get(k) for k in CONFIG4_KEYS},
         card_used_bytes=card_used, wall_s=wall, boot_s=wall - rec["seconds"])
    check(rec["config"] == "bls-qc-n256" and rec["n"] == 256 and rec["qc_mode"],
          f"config 4 ran another shape: {rec['config']}, n {rec['n']}")
    check(rec["bank_max_keys"] == 512 and rec["keys_over_cap"] == 0,
          f"config 4's bank: cap {rec['bank_max_keys']}, {rec['keys_over_cap']} keys over it")
    check(rec["committed_req_s"] > 0, f"config 4 committed nothing: {rec['committed_req_s']}")
    check(rec["svc_device_passes"] > 0 and rec["svc_cpu_passes"] == 0
          and rec["svc_cpu_reroute_passes"] == 0,
          f"config 4: {rec['svc_device_passes']} device passes, {rec['svc_cpu_passes']} CPU, "
          f"{rec['svc_cpu_reroute_passes']} rerouted")
    check(rec["svc_watchdog_failovers"] == 0 and shapes["post_warm_compiles"] == 0,
          f"config 4 left the device or met a first-time shape: {shapes}")
    check(launches["fused_accumulate"] > 0 and launches["encode_verdict"] > 0
          and launches["ladder_verify"] == 0, f"config 4 launches: {launches}")
    return {k: launches[k] for k in ("fused_accumulate", "encode_verdict")}


def _device_only(rec, what):
    """A gpu record's device checks: device passes only, none rerouted, no
    watchdog failover, no first-time shape after the warm, every key in
    the bank, and each chunk one launch of K1 and of the verdict kernel
    and none of K9 (chunks and launches read together under the device
    lock). -> the launches."""
    tally = rec["launch_tally"]
    launches = tally["launches"]
    check(rec["svc_device_passes"] > 0 and rec["svc_cpu_passes"] == 0
          and rec["svc_cpu_reroute_passes"] == 0,
          f"{what}: {rec['svc_device_passes']} device passes, {rec['svc_cpu_passes']} CPU, "
          f"{rec['svc_cpu_reroute_passes']} rerouted")
    check(rec["svc_watchdog_failovers"] == 0
          and rec["svc_device_shapes"]["post_warm_compiles"] == 0,
          f"{what} left the device or met a first-time shape: {rec['svc_device_shapes']}")
    check(rec["keys_over_cap"] == 0, f"{what}: {rec['keys_over_cap']} keys over the bank's cap")
    check(tally["chunks"] > 0 and launches["fused_accumulate"] == tally["chunks"]
          and launches["encode_verdict"] == tally["chunks"] and launches["ladder_verify"] == 0,
          f"{what}: {tally['chunks']} chunks, launches {launches}")
    return launches


def storm_checks(rec, flight_dir, n, crashes, device=True):
    """BASELINE config 5's checks on one storm record of bench_consensus
    and the flight frames its run wrote under `flight_dir`: the record's
    shape; the surviving replicas' last frames in one view, at least
    `crashes`; views installed, one NEW-VIEW sent a crash at least, no
    certificate of the honest committee rejected by a precheck; every
    survivor's executed sequence rising after its first frame in the
    final view; and with `device`, the gpu record's device checks. The
    crashed replicas' old views stand in the record's end telemetry, so
    the views are read from the frames. -> a summary, which every failed
    check's message carries."""
    check(rec["config"] == f"viewchange-storm-pbft-n{n}" and rec["n"] == n
          and rec.get("primary_crashes") == crashes,
          f"storm ran another shape: {rec['config']}, n {rec['n']}, "
          f"crashes {rec.get('primary_crashes')}")
    frames = {}
    for path in sorted(glob.glob(os.path.join(flight_dir, "*.flight.jsonl"))):
        with open(path) as fh:
            docs = [json.loads(line) for line in fh if line.strip()]
        # a stall's autopsy lands in the same file: keep the frames, each
        # as its replica block with the frame's uptime
        frames[os.path.basename(path).split(".")[0]] = [
            {**d["replica"], "t": d["uptime_s"]} for d in docs if "replica" in d]
    check(len(frames) == n and all(frames.values()),
          f"{len(frames)} replicas' flight frames, not {n}")
    survivors = {rid: fr for rid, fr in frames.items() if fr[-1]["running"]}
    # the failovers' timeline in seconds since the replicas started: when
    # each crashed replica's frames first show it stopped, and the first
    # and last survivor's first frame in each view it installed
    installs = {}
    for fr in survivors.values():
        for v in sorted({f["view"] for f in fr} - {0}):
            installs.setdefault(v, []).append(next(f["t"] for f in fr if f["view"] == v))
    ends = {}
    for rid, fr in survivors.items():
        ends.setdefault(fr[-1]["view"], []).append(rid)
    metrics = rec["telemetry"]["end"]["replica_metrics"]
    counts = {k: metrics.get(k, 0) for k in ("views_installed", "new_views_sent",
                                             "bad_newview_precheck", "bad_viewchange_precheck")}
    summary = {"survivors": len(survivors),
               "crash_s": sorted(next(f["t"] for f in fr if not f["running"])
                                 for rid, fr in frames.items() if rid not in survivors),
               "install_s": {str(v): [min(ts), max(ts), len(ts)]
                             for v, ts in sorted(installs.items())},
               "end_views": {str(v): len(rids) for v, rids in sorted(ends.items())},
               "end_s": max(fr[-1]["t"] for fr in frames.values()), **counts}
    check(len(survivors) == n - crashes,
          f"{len(survivors)} survivors of {n} after {crashes} crashes: {summary}")
    check(len(ends) == 1 and min(ends) >= crashes,
          f"the survivors end in views {sorted(ends)}: {summary}")
    final = min(ends)
    rises = {}
    for rid, fr in survivors.items():
        first = next(f for f in fr if f["view"] == final)
        rises[rid] = fr[-1]["executed_seq"] - first["executed_seq"]
    summary.update(final_view=final,
                   exec_rise_after_final_view=[min(rises.values()), max(rises.values())])
    stalled = sorted(rid for rid, d in rises.items() if d <= 0)
    check(not stalled, f"no commit in view {final} after its first frame at {stalled}: {summary}")
    check(counts["views_installed"] > 0 and counts["new_views_sent"] >= crashes,
          f"failovers not installed: {summary}")
    check(counts["bad_newview_precheck"] == 0 and counts["bad_viewchange_precheck"] == 0,
          f"an honest committee's certificate failed its precheck: {summary}")
    check(rec["max_newview_bytes"] > 0, f"no NEW-VIEW was built: {summary}")
    if device:
        summary["launches"] = _device_only(rec, "config 5")
    return summary


# BASELINE config 5 (BASELINE.md:32): 64 replicas (f = 21) in one process,
# the bench's 8 clients x 128 in flight and blocks of up to 256, three
# successive crash-stops of the current primary, every verify pile (the
# certificates' nested signatures too) on the card. The view timer and the
# window are chosen on the card (PERF.md section 4)
CONFIG5_T, CONFIG5_S, CONFIG5_CRASHES = 15, 260, 3
CONFIG5_ARGS = ("--configs", "3", "--storm", "--verifier", "gpu", "--verify-cpu-cutoff", "0",
                "--crashes", str(CONFIG5_CRASHES), "--clients", "8", "--outstanding", "128",
                "--batch", "256", "--seconds", str(CONFIG5_S), "--view-timeout", str(CONFIG5_T))
CONFIG5_KEYS = ("config", "n", "clients", "outstanding", "window_s", "seconds", "committed_req_s",
                "completed_total", "p50_ms", "p99_ms", "client_timeouts", "replica_exec_min",
                "replica_exec_max", "primary_crashes", "max_viewchange_bytes", "max_newview_bytes",
                "verify_calls", "verify_batch_mean", "verify_ms_mean", "svc_device_passes",
                "svc_device_items", "svc_max_coalesced", "svc_max_pending_seen", "svc_rtt_ms_ema",
                "launch_tally", "bank_keys", "bank_max_keys", "keys_over_cap", "loop_lag")


def phase_config5():
    """python -m simple_pbft_tpu_torch.bench_consensus --configs 3 --storm
    --verifier gpu: BASELINE config 5 in one process, its flight frames
    under a directory removed when the phase returns. The checks are
    storm_checks'; the line prints the largest dispatch and how many were
    split into chunks of the top bucket."""
    from simple_pbft_tpu_torch.crypto.gpu_verifier import BUCKETS

    flight = tempfile.mkdtemp(prefix="chip_smoke_config5_")
    try:
        t0 = time.perf_counter()
        recs, card_used = _run_sampled(["simple_pbft_tpu_torch.bench_consensus", *CONFIG5_ARGS,
                                        "--flight-dir", flight], "committed_req_s", 900)
        rec = recs[-1]
        wall = time.perf_counter() - t0
        summary = storm_checks(rec, flight, 64, CONFIG5_CRASHES)
    finally:
        shutil.rmtree(flight, ignore_errors=True)
    tally = rec["launch_tally"]
    emit("config5", args=list(CONFIG5_ARGS), record={k: rec.get(k) for k in CONFIG5_KEYS},
         storm=summary, largest_dispatch=tally["max_dispatch_items"],
         chunked_dispatches=tally["chunked_dispatches"],
         crossed_top_bucket=tally["max_dispatch_items"] > BUCKETS[-1],
         card_used_bytes=card_used, wall_s=wall, boot_s=wall - rec["seconds"])
    return {k: summary["launches"][k] for k in ("fused_accumulate", "encode_verdict")}


# the n = 100 committee (BASELINE.json's metric, committed req/s at n = 100)
# in one process: PBFT with Ed25519 votes, then BLS quorum certificates,
# each with every verify pile on the card
N100_S = 20
N100_ARGS = ("--configs", "100,qc100", "--verifier", "gpu", "--verify-cpu-cutoff", "0",
             "--seconds", str(N100_S))
N100_KEYS = CONFIG3_KEYS + ("qc_mode", "seconds", "bank_max_keys", "bank_slots", "keys_over_cap",
                            "launch_tally")


def phase_n100():
    """python -m simple_pbft_tpu_torch.bench_consensus --configs 100,qc100
    --verifier gpu: the n = 100 committee without and with BLS
    certificates, one process, two records."""
    t0 = time.perf_counter()
    recs, card_used = _run_sampled(["simple_pbft_tpu_torch.bench_consensus", *N100_ARGS],
                                   "committed_req_s", 900)
    wall = time.perf_counter() - t0
    check([(r["config"], r["n"], r["qc_mode"]) for r in recs]
          == [("pbft-n100", 100, False), ("bls-qc-n100", 100, True)],
          f"n = 100 ran other shapes: {[(r['config'], r['n']) for r in recs]}")
    launches = {"fused_accumulate": 0, "encode_verdict": 0}
    for r in recs:
        check(r["committed_req_s"] > 0, f"{r['config']} committed nothing")
        check(r["bank_max_keys"] == 512, f"{r['config']}: bank cap {r['bank_max_keys']}")
        for k, v in _device_only(r, r["config"]).items():
            if k in launches:
                launches[k] += v
    emit("n100", args=list(N100_ARGS), records={r["config"]: {k: r.get(k) for k in N100_KEYS}
                                                for r in recs},
         card_used_bytes=card_used, wall_s=wall,
         boot_s=wall - sum(r["seconds"] for r in recs), cpu_count=os.cpu_count())
    return launches


# the sim's STORM scenario (tests/test_sim.py), run twice
SIM_SCENARIO = dict(seed=11, n=4, requests=8, horizon=10.0, probes=2,
                    gen=dict(crashes=1, partition_windows=1, drop_windows=1))


def phase_sim():
    """The port's deterministic simulator (no kernel: the committee
    verifies on the CPU, as the JAX sim's does): the same seed twice must
    pass its oracles with the same trace fingerprint."""
    from simple_pbft_tpu_torch.sim import Scenario, run_scenario

    runs = [run_scenario(Scenario(**SIM_SCENARIO)) for _ in range(2)]
    for r in runs:
        check(r.ok, f"sim scenario failed: {r.failure}")
    check(runs[0].fingerprint == runs[1].fingerprint,
          f"sim fingerprints differ: {[r.fingerprint for r in runs]}")
    emit("sim", scenario=SIM_SCENARIO, fingerprint=runs[0].fingerprint,
         committed=runs[0].committed, vtime_s=runs[0].vtime_s,
         wall_s=[r.wall_s for r in runs], coverage=runs[0].coverage)


# the bench's runs: its defaults (fused, w = 5, dense rows), w = 4 (the
# number of earlier runs) and the comb mode
BENCH_RUNS = (("default", {}), ("w4", {"BENCH_WINDOW": "4"}), ("comb", {"BENCH_MODE": "comb"}))


def phase_bench():
    benches = {}
    for name, env in BENCH_RUNS:
        t0 = time.perf_counter()
        bench = _run_json(["simple_pbft_tpu_torch.bench"], "metric", 600, env)
        want = {"mode": env.get("BENCH_MODE", "fused"),
                "window": int(env.get("BENCH_WINDOW", "5" if "BENCH_MODE" not in env else "4")),
                "rowpack": False}
        check("error" not in bench and bench["platform"] == "gpu" and bench["value"] > 0
              and {k: bench.get(k) for k in want} == want, f"bench line ({name}): {bench}")
        benches[name] = {"line": bench, "seconds": time.perf_counter() - t0}
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
    emit("bench", bench=benches,
         bench_consensus={k: cons.get(k) for k in keys}, bench_consensus_s=cons_s)


def _modes_launches(modes):
    """The modes phase's launches, summed over its verifier drives."""
    return {k: sum(sum(r["drive"]["launches"][k].values()) for r in modes.values())
            for k in ("fused_accumulate", "encode_verdict", "ladder_verify")}


def _accumulate_configs(modes):
    """K1's `configs` map: each configuration at B = 8192, in the mode its
    path runs it (wire for fused, comb for comb), and its drive's
    launches."""
    top = str(MODE_BATCHES[-1])
    out = {}
    for name, r in modes.items():
        if r["mode"] == "ladder":
            continue
        row = r["by_batch"][top]
        main = row["wire"] if r["mode"] == "fused" else row["comb"]
        errs = [v["max_abs_err"] for b in r["by_batch"].values()
                for k, v in b.items() if k in ("wire", "index", "comb")]
        out[name] = {
            "batch": int(top), "parts": row["parts"], "ms": main["kernel_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "distinct_rows": main["distinct_rows"],
            "launches": r["drive"]["launches"]["fused_accumulate"][name],
            "max_abs_err": max(errs), "device_pass_ms": r["drive"]["device_pass_ms"],
            "verifies_per_s_e2e": r["drive"]["verifies_per_s_e2e"],
            **({"index_ms": row["index"]["kernel_ms"]} if r["mode"] == "fused" else {}),
        }
    return out


def kernel_rows(rows, by_path, modes, mesh, cold):
    """The kernels line: each kernel at the largest bucket, in the mode
    the main path runs it; `launches` sums the paths' counts; `configs`
    holds every configuration (K1) or entry (the verdict kernel); K1's
    `cold_rows` its times on distinct and on tiled messages."""
    launches = {k: sum(p.get(k, 0) for p in by_path.values())
                for k in ("fused_accumulate", "encode_verdict", "ladder_verify", "quorum_tally")}
    top = max(rows)
    k1 = rows[top]["wire"]
    tail = rows[top]["verdict"]
    err_k1 = max(max(r["index"]["max_abs_err"], r["wire"]["max_abs_err"]) for r in rows.values())
    err_tail = max(r["verdict"]["max_abs_err"] for r in rows.values())
    configs = _accumulate_configs(modes)
    err_k1 = max([err_k1] + [c["max_abs_err"] for c in configs.values()])
    comb_row = modes["comb_w4_dense"]
    limbs = comb_row["by_batch"][str(MODE_BATCHES[-1])]["verdict_limbs"]
    err_tail = max([err_tail] + [b["verdict_limbs"]["max_abs_err"]
                                 for b in comb_row["by_batch"].values()])
    # the verdict kernel's launches by entry: the modes' and the mesh's
    # drives count them by entry, the other paths run the wire entry only
    entry_launches = {e: mesh["verdict_entries"][e]
                      + sum(r["drive"]["launches"]["encode_verdict"].get(e, 0)
                            for r in modes.values()) for e in ("wire", "limbs")}
    main_paths = sum(v["encode_verdict"] for p, v in by_path.items()
                     if p not in ("modes", "mesh"))
    tally = mesh["tally"]
    lad = modes["ladder"]
    k9 = lad["by_batch"][str(MODE_BATCHES[-1])]["ladder"]
    return [{
        "name": "fused_accumulate",
        "route": "cuda",
        "source": "simple_pbft_tpu_torch/csrc/fused_accumulate.cu",
        "replaces": "simple_pbft_tpu/ops/comb.py:473 (_madd_loop_pallas); comb mode: "
                    ":355 (comb_accumulate), XLA",
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
        "configs": configs,
        "cold_rows": cold,
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
        "configs": {
            "wire": {"batch": top, "ms": tail["kernel_ms"], "plain_ms": tail["plain_ms"],
                     "bound_ms": tail["bound_ms"], "bound_by": tail["bound_by"],
                     "launches": main_paths + entry_launches["wire"]},
            "limbs": {"batch": MODE_BATCHES[-1], "ms": limbs["kernel_ms"],
                      "plain_ms": limbs["plain_ms"], "bound_ms": limbs["bound_ms"],
                      "bound_by": limbs["bound_by"], "launches": entry_launches["limbs"]},
        },
    }, {
        "name": "ladder_verify",
        "route": "cuda",
        "source": "simple_pbft_tpu_torch/csrc/ladder_verify.cu",
        "replaces": "simple_pbft_tpu/crypto/tpu_verifier.py:197 (verify_kernel), XLA",
        "launches": launches["ladder_verify"],
        "launches_by_path": {p: v.get("ladder_verify", 0) for p, v in by_path.items()},
        "max_abs_err": max(b["ladder"]["max_abs_err"] for b in lad["by_batch"].values()),
        "batch": MODE_BATCHES[-1],
        "ms": k9["kernel_ms"],
        "plain_ms": k9["plain_ms"],
        "bound_ms": k9["bound_ms"],
        "bound_by": k9["bound_by"],
        "library_ms": None,
        "library": "none: no PyTorch call computes it",
        "configs": {"ladder": {"batch": MODE_BATCHES[-1], "ms": k9["kernel_ms"],
                               "plain_ms": k9["plain_ms"], "bound_ms": k9["bound_ms"],
                               "bound_by": k9["bound_by"],
                               "launches": lad["drive"]["launches"]["ladder_verify"]["ladder_verify"],
                               "device_pass_ms": lad["drive"]["device_pass_ms"],
                               "verifies_per_s_e2e": lad["drive"]["verifies_per_s_e2e"]}},
    }, {
        "name": "quorum_tally",
        "route": "cuda",
        "source": "simple_pbft_tpu_torch/csrc/quorum_tally.cu",
        "replaces": "simple_pbft_tpu/parallel/sharded_verify.py:133 and :163 (the tally of "
                    "make_comb_quorum_step :105 and make_quorum_step :140), XLA",
        "launches": launches["quorum_tally"],
        "launches_by_path": {p: v.get("quorum_tally", 0) for p, v in by_path.items()},
        "max_abs_err": tally["max_abs_err"],
        "batch": tally["batch"],
        "n_inst": tally["n_inst"],
        "ms": tally["kernel_ms"],
        "back_to_back_ms": tally["back_to_back_ms"],
        "profiler_us": tally["profiler_us"],
        "host_us": tally["host_us"],
        "plain_ms": tally["plain_ms"],
        "bound_ms": tally["bound_ms"],
        "bound_by": tally["bound_by"],
        "library_ms": tally["library_ms"],
        "library": tally["library"],
        "configs": {path: {"batch": tally["batch"], "n_inst": tally["n_inst"],
                           "ms": r["kernel_ms"], "back_to_back_ms": r["back_to_back_ms"],
                           "profiler_us": r["profiler_us"], "host_us": r["host_us"],
                           "bound_ms": tally["bound_ms"], "bound_by": tally["bound_by"],
                           "shapes_checked": tally["shapes_by_path"][path]}
                    for path, r in tally["by_path"].items()},
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
    seconds = {}

    def timed(phase, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[phase] = time.perf_counter() - t0
        return out

    timed("device", phase_device)
    timed("build", phase_build)
    timed("field", phase_field)
    timed("sim", phase_sim)
    rows = timed("kernel", phase_kernel)
    modes = timed("modes", phase_modes)
    mesh = timed("mesh", phase_mesh)
    verifier = timed("verifier", phase_verifier)
    cold = timed("costmodel", phase_costmodel, verifier)
    by_path = {"committee": timed("committee", phase_committee, args.view_timeout)}
    by_path["deployment"] = timed("deployment", phase_deployment)
    by_path["replica_unit"] = timed("replica_unit", phase_replica_unit)
    by_path["config3"] = timed("config3", phase_config3)
    by_path["config4"] = timed("config4", phase_config4)
    by_path["config5"] = timed("config5", phase_config5)
    by_path["n100"] = timed("n100", phase_n100)
    by_path["modes"] = _modes_launches(modes)
    for kernel, count in by_path["modes"].items():
        check(count > 0, f"the modes phase's drives never launched {kernel}")
    by_path["mesh"] = mesh["launches"]
    for kernel, count in by_path["mesh"].items():
        check(count > 0, f"the mesh phase's drives never launched {kernel}")
    timed("bench", phase_bench)
    emit("done", seconds=time.perf_counter() - t_start, phase_seconds=seconds)
    print(json.dumps({"kernels": kernel_rows(rows, by_path, modes, mesh, cold)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
