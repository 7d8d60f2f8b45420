"""Benchmark: batched Ed25519 verification throughput on one GPU.

    python -m simple_pbft_tpu_torch.bench [--smoke]

Headline metric: Ed25519 verifies/sec on one card, the device rate of the
device pass at the top batch (8192); `vs_baseline` is value / 1e6, as in
the JAX package's bench.py.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...} —
ALWAYS, even on failure or timeout (an "error" field is added and the best
rate measured so far is reported, 0.0 if none). The exit code is 0 only
when the line carries no error.

Methodology: sign a small set of distinct messages (pure-Python RFC 8032),
tile them to the batch, stage the batch's arrays on the card, then time
steady-state device passes (`GpuVerifier.device_pass`: the two CUDA
kernels) between CUDA events. A small batch runs first, so a failing
kernel fails fast. Host prep (`GpuVerifier.prepare`: `prepare_wire_batch`
in fused mode, `prepare_comb_batch` in comb mode) is timed apart and
reported as `host_prep_ms` per top batch. `e2e_verifies_per_sec` is the
whole `GpuVerifier.verify_batch` path (host prep, copies, the pass, the
verdicts back); `e2e_pipelined_verifies_per_sec` dispatches batch k+1
before it waits for batch k, the overlap the verify service gets.

Env knobs, with the JAX package's bench.py defaults: BENCH_MODE (fused or
comb, default fused), BENCH_WINDOW (4, 5 or 6 bits, default 5; comb mode
is fixed at 4), BENCH_ROWPACK (1: packed 128-byte table rows, fused mode
only; default 0, dense 256-byte rows). Also BENCH_BATCH (top batch,
rounded up to a bucket, at most 8192), BENCH_SIGNERS (distinct signing
keys, default 16 — BASELINE config 2's committee), BENCH_TIMEOUT
(wall-clock budget in seconds, default 420). The JSON line carries
`mode`, `window` and `rowpack`.
``--smoke`` runs a batch of 32 on the CPU (``device="cpu"``), the
kernels' plain versions, in seconds. Without it the bench runs on CUDA
and reports an error when there is none.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

METRIC = "ed25519_verifies_per_sec_per_gpu"


class _Record:
    """The one JSON line: the best rate so far plus the facts known so
    far, emitted exactly once by whichever path ends the run."""

    def __init__(self) -> None:
        self.best = {"value": 0.0, "batch": 0, "note": "no measurement completed"}
        self.sticky: dict = {}
        self._lock = threading.Lock()
        self._emitted = False

    def emit(self, error: str | None = None, **extra) -> None:
        with self._lock:
            if self._emitted:
                return
            self._emitted = True
            rec = {
                "metric": METRIC,
                "value": round(self.best["value"], 1),
                "unit": "verifies/s",
                "vs_baseline": round(self.best["value"] / 1_000_000, 4),
                "batch": self.best["batch"],
                "note": self.best["note"],
                **self.sticky,
                **extra,
            }
            if error is not None:
                rec["error"] = error[:500]
            # os.write on the raw fd: must succeed even if the main thread
            # is blocked inside a CUDA call holding buffered-stdout state
            os.write(1, (json.dumps(rec) + "\n").encode())


def _start_watchdog(record: _Record, budget: float) -> None:
    """A blocking CUDA call cannot be interrupted by a signal handler; a
    daemon thread and os._exit always fire."""

    def fire():
        time.sleep(max(1.0, budget))
        record.emit(error=f"timeout after {budget:.0f}s: {record.best['note']}")
        os._exit(1)

    threading.Thread(target=fire, daemon=True).start()


def _card_facts() -> dict:
    """The card's name and power limit as nvidia-smi prints them."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def _measure(fn, batch: int, device, min_s: float, max_iters: int) -> float:
    """Steady-state verifies/s of `fn` (one device pass at `batch`): on
    CUDA the time between two events around the passes, on the CPU the
    host clock."""
    import torch

    cuda = device.type == "cuda"
    fn()  # warm pass
    if cuda:
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    iters = 0
    t0 = time.perf_counter()
    while True:
        fn()
        iters += 1
        if iters >= max_iters or (iters >= 3 and time.perf_counter() - t0 > min_s):
            break
    if cuda:
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        seconds = time.perf_counter() - t0
    return batch * iters / seconds


def _tile(items, batch: int):
    return (items * (batch // len(items) + 1))[:batch]


def run(record: _Record, smoke: bool, budget: float) -> dict:
    """The measurement; returns the extra fields of the JSON line."""
    t_start = time.perf_counter()
    record.best["note"] = "initializing torch"
    import torch

    from .crypto import ed25519_cpu as ref
    from .crypto.gpu_verifier import BUCKETS, GpuVerifier, _bucket_size
    from .crypto.verifier import BatchItem
    from .ops import comb

    mode = os.environ.get("BENCH_MODE", "fused")
    if mode not in ("fused", "comb"):
        raise ValueError(f"BENCH_MODE must be fused|comb, got {mode!r}")
    # comb mode is fixed at 4-bit windows and dense rows: report what runs
    wbits = int(os.environ.get("BENCH_WINDOW", "5")) if mode == "fused" else 4
    rowpack = mode == "fused" and os.environ.get("BENCH_ROWPACK", "0") == "1"
    # the layout switch precedes every bank
    comb.use_row_packing(rowpack)
    record.sticky.update(mode=mode, window=wbits, rowpack=rowpack,
                         staging="wire" if mode == "fused" else "comb")
    verifier = GpuVerifier(device="cpu" if smoke else "cuda", mode=mode, window=wbits)
    device = verifier.device
    platform = "gpu" if device.type == "cuda" else "cpu"
    record.sticky.update(platform=platform, config=verifier.config)
    if platform == "gpu":
        record.sticky.update(_card_facts())
    top = min(_bucket_size(int(os.environ.get("BENCH_BATCH", "32" if smoke else "8192"))),
              BUCKETS[-1])
    n_signers = int(os.environ.get("BENCH_SIGNERS", "16"))
    distinct = min(top, 64)
    record.best["note"] = f"signing {distinct} messages"
    items = []
    for i in range(distinct):
        seed = bytes([i % n_signers]) * 32
        msg = b"bench vote %d" % i
        items.append(BatchItem(ref.public_key(seed), msg, ref.sign(seed, msg)))

    bank = verifier._bank
    record.best["note"] = f"building {verifier.config} key tables ({n_signers} keys)"
    t0 = time.perf_counter()
    for it in items:
        bank.lookup(it.pubkey)  # the table build is one-time per key
    table_build_s = time.perf_counter() - t0

    # host prep, measured WARM at the top batch (what a replica pays)
    items_top = _tile(items, top)
    verifier.prepare(items_top)
    t0 = time.perf_counter()
    for _ in range(3):
        verifier.prepare(items_top)
    host_prep_ms = (time.perf_counter() - t0) / 3 * 1e3
    tables = bank.device_tables()

    def staged(batch: int):
        prep, _ = verifier.prepare(_tile(items, batch))
        return [torch.from_numpy(a).to(device) for a in prep.arrays()]

    best_note = record.best["note"]
    device_pass_ms = None
    for batch in sorted({_bucket_size(min(64, top)), top}):
        if time.perf_counter() - t_start > 0.75 * budget and record.best["batch"]:
            best_note += f"; skipped batch>={batch} (time budget)"
            break
        arrays = staged(batch)

        def fn():
            return verifier.device_pass(arrays, tables)

        record.best["note"] = f"first pass at batch={batch} on {platform}; best: {best_note}"
        if not bool(fn().all()):
            raise RuntimeError(f"bench batch of {batch} valid signatures did not verify")
        record.best["note"] = f"measuring batch={batch} on {platform}; best: {best_note}"
        rate = (_measure(fn, batch, device, min_s=0.1, max_iters=3) if smoke
                else _measure(fn, batch, device, min_s=1.0, max_iters=2000))
        if rate > record.best["value"]:
            record.best.update(value=rate, batch=batch)
            best_note = f"batch={batch} on {platform}"
            device_pass_ms = batch / rate * 1e3
        record.best["note"] = best_note
        print(f"batch={batch} rate={rate:,.0f}/s", file=sys.stderr)

    e2e_rate = e2e_pipe_rate = None
    b_best = record.best["batch"]
    if b_best and time.perf_counter() - t_start < 0.9 * budget:
        items_big = _tile(items, b_best)
        record.best["note"] = f"e2e at batch={b_best}; best: {best_note}"
        max_iters = 2 if smoke else 50

        def e2e_loop(step) -> float:
            """Closed prepare->dispatch loop; `step(prev)` returns the
            in-flight finisher, the last one is waited on."""
            last = None
            iters = 0
            t0 = time.perf_counter()
            while iters < max_iters and (iters < 3 or time.perf_counter() - t0 < 3.0):
                last = step(last)
                iters += 1
            if last is not None:
                last()
            return b_best * iters / (time.perf_counter() - t0)

        def serial(_prev):
            verifier.verify_batch(items_big)

        def pipelined(prev):
            nxt = verifier.dispatch_batch(items_big)
            if prev is not None:
                prev()
            return nxt

        e2e_rate = e2e_loop(serial)
        e2e_pipe_rate = e2e_loop(pipelined)
        record.best["note"] = best_note

    print(f"host_prep={host_prep_ms:.2f}ms table_build={table_build_s:.1f}s "
          f"device={platform} best={record.best['value']:,.0f}/s "
          f"e2e={e2e_rate or 0:,.0f}/s ({record.best['note']})", file=sys.stderr)
    return {
        "host_prep_ms": round(host_prep_ms, 3),
        "device_pass_ms": round(device_pass_ms, 4) if device_pass_ms else None,
        # null = not measured (budget skip), never a misleading 0.0
        "e2e_verifies_per_sec": round(e2e_rate, 1) if e2e_rate else None,
        "e2e_pipelined_verifies_per_sec": round(e2e_pipe_rate, 1) if e2e_pipe_rate else None,
        "table_build_s": round(table_build_s, 2),
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    smoke = "--smoke" in argv
    budget = float(os.environ.get("BENCH_TIMEOUT", "420"))
    record = _Record()
    _start_watchdog(record, budget)
    try:
        extra = run(record, smoke, budget)
    except Exception as e:  # noqa: BLE001 — the JSON line is always printed
        record.emit(error=f"{type(e).__name__}: {e}")
        return 1
    record.emit(**extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())
