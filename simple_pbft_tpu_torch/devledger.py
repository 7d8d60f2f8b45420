"""Device-plane event ledger.

The verify plane's cost claim was produced by hand, once. Every
other plane got continuous instrumentation (spans, wire
accounting); the device plane, where per-role crypto cost
dominates, stayed a markdown memo. This module is the continuously-
measured replacement: every jit dispatch on the verify path records one
event — (lane, mode, window, bucket, batch size, pad waste, queue wait,
host prep, device RTT, compile-vs-cache, host<->device bytes) — into a
bounded lock-free ring, and the aggregates ride
``VerifyService.snapshot()["device"]`` -> telemetry -> every flight
frame and bench record. ``tools/verify_observatory.py`` joins the
ledger with the span layer and the static cost model
(``crypto/costmodel.py``) into a measured roofline verdict per run.

Lanes share one schema so the 8-mesh shard-out inherits it day one:

  ``ed25519``  TpuVerifier jit dispatches (the coalesced verify path)
  ``bls``      QcVerifyLane RLC multi-pairing batches
  ``shard``    parallel/sharded_verify per-device SPMD step events

Discipline (PBL004): every public entry point here is audited
never-raise — recording wraps its body in a broad except because a
telemetry bug must not take down the verify pipeline it observes — and
the ledger is ZERO-overhead when disabled: ``record()`` returns after
one attribute read (A/B-asserted in tests/test_devledger.py). Like
``spans.py`` the recorder is process-wide (the verify service and QC
lane are process-wide too); events are tuples appended to a deque
(GIL-atomic, no lock on the hot path) and the aggregate counters are
plain int/float adds — observability, not control flow. Works under
``JAX_PLATFORMS=cpu`` unchanged, so tier-1 exercises the full path.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

LANE_ED25519 = "ed25519"
LANE_BLS = "bls"
LANE_SHARD = "shard"


# the raw (summable) lane counters; consumers that merge blocks across
# processes (tools/verify_observatory.py) sum exactly these keys
LANE_SUM_KEYS = (
    "dispatches", "items", "pad_items", "submissions", "busy_s",
    "host_prep_s", "queue_wait_s", "bytes_up", "bytes_down", "compiles",
)


def _zero_agg() -> Dict[str, float]:
    return {k: 0 for k in LANE_SUM_KEYS}


def lane_view(agg: Dict[str, float], elapsed: float,
              n_devices: int) -> Dict[str, Any]:
    """Derived per-lane metrics from the raw summable counters — THE
    single definition of pad-waste %, items/dispatch, effective rate,
    and occupancy, shared by the live ledger snapshot and the
    cross-process merge in tools/verify_observatory.py (a second
    hand-maintained copy of these formulas would drift silently)."""
    disp = agg["dispatches"]
    items = agg["items"]
    total = items + agg["pad_items"]
    return {
        "dispatches": int(disp),
        "items": int(items),
        "pad_items": int(agg["pad_items"]),
        "pad_waste_pct": round(100.0 * agg["pad_items"] / total, 2)
        if total else 0.0,
        "submissions": int(agg["submissions"]),
        "coalesced_subs_per_dispatch": round(
            agg["submissions"] / disp, 2) if disp else 0.0,
        "items_per_dispatch": round(items / disp, 1) if disp else 0.0,
        "dispatches_per_s": round(disp / elapsed, 2),
        "verifies_per_s_effective": round(items / elapsed, 1),
        "busy_s": round(agg["busy_s"], 4),
        # busy fraction of the window; a latency integral, so
        # overlapped (double-buffered) passes clamp at 1.0 — the
        # occupancy a roofline wants is "was the device the
        # bottleneck", and >= 1 means unambiguously yes
        "occupancy": round(
            min(1.0, agg["busy_s"] / (elapsed * max(1, n_devices))), 4),
        "host_prep_s": round(agg["host_prep_s"], 4),
        "queue_wait_s": round(agg["queue_wait_s"], 4),
        "bytes_up": int(agg["bytes_up"]),
        "bytes_down": int(agg["bytes_down"]),
        "bytes_up_per_s": round(agg["bytes_up"] / elapsed, 1),
        "compiles": int(agg["compiles"]),
        "devices": n_devices if n_devices > 1 else 1,
    }


class DeviceLedger:
    """Bounded per-dispatch event ring + per-lane / per-shape aggregates.

    Thread-safe by construction rather than by locking: the ring is a
    ``deque`` (append is GIL-atomic), counters are plain adds on a dict
    owned by one lane's recording threads in practice, and every reader
    (``snapshot``) tolerates a torn mid-update view — these numbers are
    observability, never control flow. ``configure()`` takes the only
    lock, to swap surfaces atomically against concurrent recorders.
    """

    def __init__(self, ring: int = 2048) -> None:
        self._enabled = True
        self._lock = threading.Lock()
        self._ring_size = ring
        self._tls = threading.local()
        self.node_id = ""
        self.profile_captures = 0
        self.profile_last_dir: Optional[str] = None
        self._profile: Optional[Tuple[Any, str]] = None
        self._profile_timer: Optional[Any] = None
        self._reset_locked()

    # -- lifecycle -------------------------------------------------------

    def _reset_locked(self) -> None:
        self._ring: deque = deque(maxlen=self._ring_size)
        self._lanes: Dict[str, Dict[str, float]] = {}
        self._shapes: Dict[Tuple[str, str, int, int], Dict[str, int]] = {}
        self._devices: Dict[str, set] = {}
        self._t0 = time.monotonic()
        self.recorded = 0
        self.dropped = 0

    def configure(self, node_id: str = "", enabled: bool = True) -> None:
        """Name the process and START A FRESH WINDOW — ring, aggregates
        and the rate clock reset, so warmup compiles never pollute the
        measurement window (bench cells / node serve loops call this
        right next to ``spans.configure``). ``enabled=False`` turns the
        ledger into a no-op whose only cost is one attribute read per
        would-be event."""
        with self._lock:
            self.node_id = node_id
            self._enabled = bool(enabled)
            self._reset_locked()

    @property
    def enabled(self) -> bool:
        return self._enabled

    # -- queue-wait handoff ---------------------------------------------

    def annotate(self, queue_wait_s: float, submissions: int) -> None:
        """Stash the coalesced take's admission-queue wait for the NEXT
        dispatch recorded on THIS thread (the VerifyService dispatch
        loop calls ``dispatch_batch`` synchronously, so the thread-local
        slot bridges the service layer — which knows the waits — and
        the verifier layer — which knows the dispatch). Never raises."""
        if not self._enabled:
            return
        try:
            self._tls.pending = (float(queue_wait_s), int(submissions))
        except Exception:  # noqa: BLE001 — telemetry never raises inward
            pass

    def _take_annotation(self) -> Tuple[float, int]:
        pend = getattr(self._tls, "pending", None)
        if pend is None:
            return 0.0, 1
        self._tls.pending = None
        return pend

    # -- recording -------------------------------------------------------

    def record(
        self,
        lane: str,
        mode: str,
        window: int,
        bucket: int,
        n: int,
        *,
        host_prep_s: float = 0.0,
        rtt_s: float = 0.0,
        compile_fresh: bool = False,
        bytes_up: int = 0,
        bytes_down: int = 0,
        queue_wait_s: Optional[float] = None,
        submissions: Optional[int] = None,
        device: str = "",
    ) -> None:
        """One dispatch event. ``bucket`` is the padded device batch,
        ``n`` the real item count (pad waste = bucket - n). Queue wait
        defaults to the thread-local annotation (see ``annotate``).
        Audited never-raise (PBL004): the body is broad-guarded because
        a malformed field from a new seam must drop the event, not the
        verify pass recording it."""
        if not self._enabled:
            return
        try:
            if queue_wait_s is None or submissions is None:
                q, s = self._take_annotation()
                queue_wait_s = q if queue_wait_s is None else queue_wait_s
                submissions = s if submissions is None else submissions
            end = time.monotonic()
            pad = max(0, int(bucket) - int(n))
            self._ring.append((
                lane, mode, int(window), int(bucket), int(n), pad,
                round(float(queue_wait_s), 6), round(float(host_prep_s), 6),
                round(float(rtt_s), 6), bool(compile_fresh),
                int(bytes_up), int(bytes_down), device, round(end, 6),
            ))
            agg = self._lanes.get(lane)
            if agg is None:
                agg = self._lanes.setdefault(lane, _zero_agg())
            agg["dispatches"] += 1
            agg["items"] += int(n)
            agg["pad_items"] += pad
            agg["submissions"] += int(submissions)
            agg["busy_s"] += float(rtt_s)
            agg["host_prep_s"] += float(host_prep_s)
            agg["queue_wait_s"] += float(queue_wait_s)
            agg["bytes_up"] += int(bytes_up)
            agg["bytes_down"] += int(bytes_down)
            if compile_fresh:
                agg["compiles"] += 1
            if device:
                self._devices.setdefault(lane, set()).add(device)
            skey = (lane, mode, int(window), int(bucket))
            srow = self._shapes.get(skey)
            if srow is None:
                srow = self._shapes.setdefault(
                    skey, {"dispatches": 0, "items": 0, "pad_items": 0}
                )
            srow["dispatches"] += 1
            srow["items"] += int(n)
            srow["pad_items"] += pad
            self.recorded += 1
        except Exception:  # noqa: BLE001 — telemetry never raises inward
            self.dropped += 1

    # -- export ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The aggregate ``device`` block (never raises; returns a
        minimal stub on any internal error). Top level mirrors the
        ed25519 lane when present (the consensus verify path — what
        pbft_top's DEV column and the bench gate floors read), with
        every lane broken out under ``lanes`` and per-(mode, window,
        bucket) dispatch counts under ``shapes``."""
        try:
            elapsed = max(1e-9, time.monotonic() - self._t0)
            lanes = {}
            # iterate KEY snapshots throughout (list(dict) is one
            # C-level pass): a recorder thread inserting a new lane or
            # shape mid-read must not raise dictionary-changed-size
            # out of the exporter — the rows themselves only ever
            # mutate fixed keys, so dict(row) copies are safe
            for lane in sorted(list(self._lanes)):
                agg = self._lanes.get(lane)
                if agg is None:
                    continue
                nd = len(self._devices.get(lane, ())) or 1
                lanes[lane] = lane_view(dict(agg), elapsed, nd)
            shapes: Dict[str, Any] = {}
            for skey in sorted(list(self._shapes)):
                row = self._shapes.get(skey)
                if row is None:
                    continue
                ln, m, w, b = skey
                # lane-qualified keys: "ed25519:fused/w4/b8192" — the
                # lane prefix keeps e.g. an ed25519 ladder shape and
                # the shard wrapper's identical (mode, window, bucket)
                # from overwriting each other in the export
                shapes[f"{ln}:{m}/w{w}/b{b}"] = dict(row)
            top_src = lanes.get(LANE_ED25519)
            if top_src is None and lanes:
                top_src = next(iter(lanes.values()))
            out: Dict[str, Any] = {
                "enabled": self._enabled,
                # the ledger is ONE PER PROCESS: the id lets consumers
                # that see the same block through several per-replica
                # flight files (an in-process committee writes n files
                # embedding one ledger) dedup instead of n-fold-count
                "node": self.node_id,
                "window_s": round(elapsed, 3),
                "recorded": self.recorded,
                "dropped": self.dropped,
                "lanes": lanes,
                "shapes": shapes,
                "profile_captures": self.profile_captures,
            }
            for k in TOP_MIRROR_KEYS:
                out[k] = top_src[k] if top_src else _EMPTY_TOP[k]
            return out
        except Exception:  # noqa: BLE001 — telemetry never raises inward
            return {"enabled": self._enabled, "error": "snapshot failed"}

    def recent(self, limit: int = 256) -> List[Dict[str, Any]]:
        """The last ``limit`` events as dicts (observatory deep view,
        autopsy dumps, tests)."""
        tail = list(self._ring)[-limit:]
        out = []
        for (lane, mode, window, bucket, n, pad, qw, hp, rtt, comp,
             b_up, b_down, device, end) in tail:
            out.append({
                "evt": "dispatch",
                "lane": lane,
                "mode": mode,
                "window": window,
                "bucket": bucket,
                "n": n,
                "pad": pad,
                "queue_wait_s": qw,
                "host_prep_s": hp,
                "rtt_s": rtt,
                "compile": comp,
                "bytes_up": b_up,
                "bytes_down": b_down,
                "device": device,
                "t_mono": end,
            })
        return out

    # -- optional deep capture (--device-profile) ------------------------

    def arm_profile(self, out_dir: str, seconds: float) -> bool:
        """Start ONE bounded ``torch.profiler`` trace capture now, ended
        after ``seconds`` (at most 120) or by ``stop_profile``, whichever
        comes first. Never raises; a second arm while one is open is a
        no-op. Artifacts land under ``out_dir`` (the flight dir in
        node.py / bench_consensus). Returns whether a capture was armed.

        A torch.profiler session belongs to the thread that starts it:
        started on a sidecar thread it records nothing, and it can only
        be stopped where it started. So both ends run on the calling
        thread (the process's main thread, where node.py and
        bench_consensus call this from their event loop): the timed end
        is scheduled on the running loop, whose thread it blocks while
        the trace is written. CUDA kernel activity is recorded from
        every thread of the process."""
        if not self._enabled or self._profile is not None or seconds <= 0:
            return False
        try:
            import asyncio  # noqa: PLC0415
            import os  # noqa: PLC0415

            import torch  # noqa: PLC0415
            import torch.profiler as tp  # noqa: PLC0415

            os.makedirs(out_dir, exist_ok=True)
            acts = [tp.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(tp.ProfilerActivity.CUDA)
            prof = tp.profile(
                activities=acts,
                on_trace_ready=tp.tensorboard_trace_handler(out_dir),
            )
            prof.start()
            self._profile = (prof, out_dir)
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                loop = None  # no loop: the caller ends it (stop_profile)
            if loop is not None:
                self._profile_timer = loop.call_later(
                    min(float(seconds), 120.0), self.stop_profile
                )
            return True
        except Exception:  # noqa: BLE001 — capture is best-effort
            return False

    def stop_profile(self) -> None:
        """End an open capture and write its trace. Call it on the thread
        that armed it; a process that exits inside the window would
        otherwise lose the whole capture. Never raises."""
        if self._profile is None:
            return
        prof, out_dir = self._profile
        self._profile = None
        if self._profile_timer is not None:
            self._profile_timer.cancel()
            self._profile_timer = None
        try:
            prof.stop()
            self.profile_captures += 1
            self.profile_last_dir = out_dir
        except Exception:  # noqa: BLE001 — capture is best-effort
            pass


# the lane metrics mirrored at the block's top level (the consensus
# verify lane's view — what pbft_top's DEV cell and the bench-gate
# floors read without digging into lanes). THE single definition:
# DeviceLedger.snapshot and tools/verify_observatory's merger both
# iterate this, so a new lane_view metric propagates everywhere or
# nowhere — never to one surface only.
_EMPTY_TOP: Dict[str, Any] = {
    "dispatches": 0, "items": 0, "pad_waste_pct": 0.0, "occupancy": 0.0,
    "items_per_dispatch": 0.0, "dispatches_per_s": 0.0,
    "verifies_per_s_effective": 0.0, "busy_s": 0.0, "host_prep_s": 0.0,
    "queue_wait_s": 0.0, "bytes_up": 0, "bytes_down": 0, "compiles": 0,
    "coalesced_subs_per_dispatch": 0.0,
}
TOP_MIRROR_KEYS = tuple(_EMPTY_TOP)

# the process-wide ledger (the verify service, QC lane and shard mesh
# are process-wide; per-node deployments get one ledger per process)
_ledger = DeviceLedger()


def ledger() -> DeviceLedger:
    return _ledger


def configure(node_id: str = "", enabled: bool = True) -> None:
    _ledger.configure(node_id, enabled=enabled)


def record(lane: str, mode: str, window: int, bucket: int, n: int,
           **kw: Any) -> None:
    _ledger.record(lane, mode, window, bucket, n, **kw)


def annotate(queue_wait_s: float, submissions: int) -> None:
    _ledger.annotate(queue_wait_s, submissions)


def take_annotation() -> Tuple[float, int]:
    """Consume the current thread's pending queue-wait annotation
    (0.0, 1 when none). Never raises."""
    try:
        return _ledger._take_annotation()
    except Exception:  # noqa: BLE001 — telemetry never raises inward
        return 0.0, 1


def snapshot() -> Dict[str, Any]:
    return _ledger.snapshot()


def recent(limit: int = 256) -> List[Dict[str, Any]]:
    return _ledger.recent(limit)


def arm_profile(out_dir: str, seconds: float) -> bool:
    return _ledger.arm_profile(out_dir, seconds)


def stop_profile() -> None:
    _ledger.stop_profile()
