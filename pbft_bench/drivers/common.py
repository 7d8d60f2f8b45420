"""What the drivers share: the card check, the process's device facts,
the reference's check of sampled verdicts, and the traced window's
host hooks."""

from __future__ import annotations

import gc
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import devtrace, roofline
from ..harness import NoCard
from ..reference import ed25519 as ref_ed25519
from ..reference.ed25519 import L

# the tests' rehearsal on the CPU: the verifier's buckets cut, as the
# port's own CPU tests cut them
REHEARSAL_BUCKETS = (8, 32)


def open_device(chips: int, rehearse: bool):
    """-> (torch, device name). Raises NoCard without enough CUDA cards;
    a rehearsal runs the program's plain versions on the CPU."""
    import torch

    if rehearse:
        from simple_pbft_tpu_torch.crypto import gpu_verifier

        gpu_verifier.BUCKETS = REHEARSAL_BUCKETS
        return torch, "cpu"
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} CUDA cards, the cell needs {chips}")
    return torch, "cuda"


def device_facts(torch, device: str) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "sms": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "sms": torch.cuda.get_device_properties(0).multi_processor_count}


def card_memory_used(torch, device: str) -> int:
    """Bytes in use on the card, every process's context and pool."""
    if device == "cpu":
        return 0
    free, total = torch.cuda.mem_get_info()
    return int(total - free)


def service_counters(svc) -> dict:
    """The service's passes and items, and the `verify.host_prep` spans'
    total ms (count x mean of the process's span histogram)."""
    from simple_pbft_tpu_torch import spans

    prep = spans.snapshot()["stages"].get(spans.VERIFY_HOST_PREP, {"count": 0, "mean": 0.0})
    return {"passes": svc.device_passes, "pass_items": svc.device_pass_items,
            "prep_ms": prep["count"] * prep["mean"]}


def reference_mismatches(items: Sequence[Tuple[bytes, bytes, bytes]],
                         answers: Sequence[bool]) -> int:
    """Items whose answer differs from RFC 8032 under the program's policy."""
    return sum(ref_ed25519.verify(*it) != ans for it, ans in zip(items, answers))


class TraceHooks:
    """A traced window's host side in one process: the device trace, the
    collector's pauses (gc.callbacks), and each device pass's host
    staging interval and items (around `GpuVerifier.prepare`), from which
    the pass's least time is counted. Installed at the end of set-up."""

    def __init__(self, verifier, items: Optional[Sequence] = None,
                 key_index: Optional[Dict[bytes, int]] = None):
        self.trace = devtrace.DeviceTrace()
        self.gc_iv: List[Tuple[int, int]] = []
        self._gc_t = 0
        gc.callbacks.append(self._gc)
        self.prep_iv: List[Tuple[int, int]] = []
        self.passes: List[Tuple[int, np.ndarray]] = []
        # a pass's items are known where the pool is (the floods)
        pos = {id(it): k for k, it in enumerate(items)} if items is not None else None
        self._rows = _row_table(items, key_index) if items is not None else None
        self._verifier = verifier
        prepare = verifier.prepare

        def traced_prepare(batch):
            t0 = time.monotonic_ns()
            out = prepare(batch)
            t1 = time.monotonic_ns()
            self.prep_iv.append((t0, t1))
            if pos is not None:
                idx = np.fromiter((pos.get(id(it), -1) for it in batch), np.int64, len(batch))
                self.passes.append((t1, idx))
            return out

        verifier.prepare = traced_prepare

    def _gc(self, phase, info) -> None:
        if phase == "start":
            self._gc_t = time.monotonic_ns()
        else:
            self.gc_iv.append((self._gc_t, time.monotonic_ns()))

    def stop(self, w0: float, w1: float, sms: int, sampled_passes: int = 32) -> dict:
        """End the trace -> the window's device events, host intervals and
        the least time of a pass, all on the Unix clock in ns."""
        off = devtrace.mono_to_unix_ns()
        lo, hi = int(w0 * 1e9), int(w1 * 1e9)
        events = self.trace.stop(lo + off, hi + off)
        gc.callbacks.remove(self._gc)
        del self._verifier.prepare

        def clip(ivs):
            return [(max(a, lo) + off, min(b, hi) + off) for a, b in ivs if b > lo and a < hi]

        inside = [idx for t, idx in self.passes if lo <= t <= hi]
        pick = inside[:: max(1, len(inside) // sampled_passes)][:sampled_passes]
        least = [roofline.pass_least_s(self._rows[idx[idx >= 0]], sms) for idx in pick]
        return {"events": events, "gc": clip(self.gc_iv), "prep": clip(self.prep_iv),
                "lo": lo + off, "pass_least_s": float(np.mean(least)) if least else None}


def _row_table(items, key_index: Dict[bytes, int]) -> np.ndarray:
    """(len(items), 64) ids of the table rows each item's pass reads."""
    n = len(items)
    ki = np.fromiter((key_index.get(it.pubkey, 0) for it in items), np.int64, n)
    s = np.frombuffer(b"".join(it.sig[32:64].ljust(32, b"\0") for it in items),
                      np.uint8).reshape(n, 32)
    ks = b"".join((int.from_bytes(hashlib.sha512(it.sig[:32] + it.pubkey + it.msg).digest(),
                                  "little") % L).to_bytes(32, "little") for it in items)
    k = np.frombuffer(ks, np.uint8).reshape(n, 32)
    return roofline.row_ids(ki, s, k).astype(np.int32)


def sleep_until(t: float) -> None:
    while True:
        d = t - time.monotonic()
        if d <= 0:
            return
        time.sleep(min(d, 0.05))


def join_traces(traces: Sequence[dict], window_s: float, default_gap: str) -> dict:
    """The card's timeline from every process's trace: busy time, the
    verify kernels' time and least time, the collector's time, and the
    breakdown (device time by operation, the longest idle gaps by what
    the host was doing)."""
    events = [e for t in traces for e in t["events"]]
    lo = min(t["lo"] for t in traces)
    hi = lo + int(window_s * 1e9)
    merged = devtrace.union([(a, b) for a, b, _ in events])
    kernel_s = sum(b - a for a, b, name in events
                   if "fused_accumulate" in name or "encode_verdict" in name) / 1e9
    least = sum(sum("fused_accumulate" in name for _, _, name in t["events"]) * t["pass_least_s"]
                for t in traces if t["pass_least_s"] is not None)
    host = {"gc": [iv for t in traces for iv in t["gc"]],
            "host_staging": [iv for t in traces for iv in t["prep"]]}
    return {
        "traced_processes": sum(1 for t in traces if t["events"]),
        "device_busy_s": devtrace.busy_ns(merged) / 1e9,
        "gc_s": sum(b - a for t in traces for a, b in t["gc"]) / 1e9,
        "verify_kernel_s": kernel_s,
        "verify_least_s": least,
        "breakdown": {"device_ops": devtrace.device_ops(events),
                      "idle_gaps": devtrace.label_gaps(devtrace.gaps(merged, lo, hi),
                                                       host, default_gap)},
    }
