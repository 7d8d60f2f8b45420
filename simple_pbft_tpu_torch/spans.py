"""Critical-path span layer.

Steady-state consensus drove the device far below its microbench
rate, and nothing in the telemetry plane could say where the rest
went — the counters count but cannot ATTRIBUTE. This module is the attribution layer: monotonic-
clock, allocation-light span records for every stage of the verify
critical path and the consensus pipeline, so a commit's latency
decomposes into named waits instead of one opaque number.

A span is (stage, start, duration) plus whatever ids the stage has
(node, view/seq slot, request id, item count). Recording is one tuple
append into a bounded ring plus one O(1) histogram update under a lock —
no dict is built unless the span is exported or persisted. Stages:

  verify.queue       VerifyService admission-queue wait (submit -> take)
  verify.host_prep   TpuVerifier host-side batch prep before dispatch
  verify.device      device dispatch -> result RTT (one coalesced pass)
  verify.cpu         CPU small-batch pass
  verify.cpu_reroute CPU reroute chunk (quarantine / depth-full big pile)
  qc.queue           QcVerifyLane wait (cert submit -> batch start)
  qc.pairing         one RLC multi-pairing batch
  replica.verify_wait  a sweep's verify from the replica's seat (queue +
                       device + resolution, the full service round trip)
  phase.prepare      pre-prepare admission -> slot prepared
  phase.commit       prepared -> commit certificate formed
  phase.execute      commit certificate -> applied in order
  execute.spec       admission -> speculative reply sent
  execute.final      admission -> applied in order (the same slot's
                     full commit latency, comparable against spec)
  transport.queue    local-transport residency (enqueue -> recv), fault
                     delay included — the wire's contribution
  client.e2e         client submit -> f+1 accepted

The three phase.* spans of a slot tile its end-to-end commit latency
exactly (same clock, adjacent endpoints), which is what lets
``tools/critical_path.py`` check its decomposition against the measured
``commit_ms`` histogram — the acceptance reconciliation.

One recorder per process (like consensus/qc.py's verify lane): the
coalescing service and the QC lane are process-wide anyway, and
per-node spans carry their node id in the record. ``configure()``
attaches the JSONL sink (``<log-dir>/<id>.spans.jsonl`` in node.py;
``<flight-dir>/<config>.spans.jsonl`` in bench_consensus). High-volume
stages (per-message transport residency) record with ``persist=False``:
histogram only — never a file line per message, and never a slot in the
recent ring the autopsy exports.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional

from . import clock, sanitize
from .logutil import Histogram

# canonical stage names (keep tools/critical_path.py's grouping in sync)
VERIFY_QUEUE = "verify.queue"
VERIFY_HOST_PREP = "verify.host_prep"
VERIFY_DEVICE = "verify.device"
VERIFY_CPU = "verify.cpu"
VERIFY_REROUTE = "verify.cpu_reroute"
QC_QUEUE = "qc.queue"
QC_PAIRING = "qc.pairing"
REPLICA_VERIFY_WAIT = "replica.verify_wait"
PHASE_PREPARE = "phase.prepare"
PHASE_COMMIT = "phase.commit"
PHASE_EXECUTE = "phase.execute"
# the phase.execute split: both measured from pre-prepare
# ADMISSION so their percentiles are directly comparable — the gap
# between p50(execute.spec) and p50(execute.final) IS the speculative
# win. phase.execute keeps its commit-cert→applied meaning (the tiling/
# reconciliation contract below depends on it); these two are the
# attribution overlay, not a rename.
EXECUTE_SPEC = "execute.spec"      # admission -> speculative reply sent
EXECUTE_FINAL = "execute.final"    # admission -> applied in order
TRANSPORT_QUEUE = "transport.queue"
CLIENT_E2E = "client.e2e"

# the slot-level stages that tile a commit's end-to-end latency, in
# pipeline order (critical_path.py reconciles their sum against commit_ms)
PHASE_STAGES = (PHASE_PREPARE, PHASE_COMMIT, PHASE_EXECUTE)


class SpanRecorder:
    """Bounded-memory span sink: per-stage histograms + a recent ring +
    an optional line-flushed JSONL file.

    Thread-safe (`record` is called from the event loop, the verify
    dispatcher/completion threads, the QC lane worker, and reroute
    threads). The main lock covers one deque append and one histogram
    update — nanoseconds — so an event-loop recorder (per-message
    transport spans) can never block behind disk. Sink writes happen
    OUTSIDE it under their own lock, and on failure the sink degrades
    to the in-memory surfaces exactly like the flight recorder
    (telemetry must never take down the node it observes)."""

    def __init__(self, ring: int = 4096) -> None:
        self._lock = sanitize.wrap_lock(threading.Lock(), "spans.recorder")
        # serializes file I/O only; same sanitizer group as _lock: the
        # two must never be held together (sink I/O off the ring lock)
        self._sink_lock = sanitize.wrap_lock(threading.Lock(), "spans.sink")
        self._ring: deque = deque(maxlen=ring)
        self._hists: Dict[str, Histogram] = {}
        self._sink = None
        self.node_id = ""
        self.recorded = 0
        self.persisted = 0

    def configure(self, node_id: str, path: Optional[str] = None) -> None:
        """Name the process (multi-process deployments: the node id),
        attach the JSONL sink, and START A FRESH SURFACE — histograms,
        ring, and counters reset, so a process running several
        measurement cells (bench_consensus config ladder) never bleeds
        one cell's spans into the next cell's record."""
        from .telemetry import _JsonlSink  # no cycle: telemetry never

        # imports spans at module level
        with self._sink_lock:
            old = self._sink
            if old is not None:
                old.close()
            new_sink = _JsonlSink(path) if path else None
        with self._lock:
            self.node_id = node_id
            self._sink = new_sink
            self._ring.clear()
            self._hists = {}
            self.recorded = 0
            self.persisted = 0

    def record(
        self,
        stage: str,
        dur: float,
        *,
        node: Optional[str] = None,
        view: Optional[int] = None,
        seq: Optional[int] = None,
        rid: Optional[str] = None,
        n: Optional[int] = None,
        persist: bool = True,
    ) -> None:
        """One span: ``dur`` seconds of ``stage``, ending now. The record
        is stamped with its END time on the clock seam (monotonic on real
        runs, virtual under the sim loop — so sim span ledgers are
        byte-deterministic and joinable with trace-plane edge docs) —
        start is end - dur, same clock. ``persist=False`` marks
        per-message-volume stages: histogram only — no file line, and no
        slot in the recent ring (an autopsy's last-N window must hold the
        pipeline spans that diagnose a wedge, not thousands of transport
        residencies)."""
        end = clock.now()
        rec = (stage, end, dur, node, view, seq, rid, n)
        with self._lock:
            h = self._hists.get(stage)
            if h is None:
                h = self._hists[stage] = Histogram()
            h.record(dur * 1e3)
            self.recorded += 1
            sink = None
            if persist:
                self._ring.append(rec)
                sink = self._sink
        if sink is not None:
            doc = self._to_doc(rec)
            with self._sink_lock:
                sink.write(doc)
                if sink._fh is not None:
                    # counted only when the line actually landed: a sink
                    # degraded by ENOSPC must not keep inflating the
                    # on-disk count post-mortem tooling trusts
                    self.persisted += 1

    def emit(self, doc: Dict[str, Any]) -> None:
        """Write one non-span ledger doc straight to the JSONL sink.

        The trace plane's cross-node edge events and per-certificate
        quorum docs (trace.py) share the span ledger file — one
        ``<id>.spans.jsonl`` per node is the unit slot_trace joins —
        but they are not spans: no histogram, no ring slot, and no-op
        when no sink is attached. Never raises (a ledger write must not
        be able to take down the transport or consensus path calling
        it)."""
        try:
            with self._lock:
                sink = self._sink
            if sink is None:
                return
            with self._sink_lock:
                sink.write(doc)
                if sink._fh is not None:
                    self.persisted += 1
        except Exception:
            pass

    def _to_doc(self, rec) -> Dict[str, Any]:
        stage, end, dur, node, view, seq, rid, n = rec
        doc: Dict[str, Any] = {
            "evt": "span",
            "stage": stage,
            "node": node if node is not None else self.node_id,
            "t_mono": round(end, 6),
            "dur_ms": round(dur * 1e3, 4),
        }
        if view is not None:
            doc["view"] = view
        if seq is not None:
            doc["seq"] = seq
        if rid is not None:
            doc["rid"] = rid
        if n is not None:
            doc["n"] = n
        return doc

    def recent(self, limit: int = 256) -> List[Dict[str, Any]]:
        """The last ``limit`` spans as dicts (autopsy dumps, tests)."""
        with self._lock:
            tail = list(self._ring)[-limit:]
        return [self._to_doc(rec) for rec in tail]

    def stage_summaries(self) -> Dict[str, Dict[str, float]]:
        """Per-stage histogram summaries, ms (telemetry snapshots)."""
        with self._lock:
            return {s: h.summary() for s, h in sorted(self._hists.items())}

    def snapshot(self) -> Dict[str, Any]:
        sink = self._sink
        return {
            "recorded": self.recorded,
            "persisted": self.persisted,
            # nonzero = the JSONL surface is truncated (sink degraded to
            # in-memory on a write failure); critical_path consumers
            # should distrust file completeness past that point
            "sink_write_errors": sink.write_errors if sink is not None else 0,
            "stages": self.stage_summaries(),
        }

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None


# the process-wide recorder (every in-process node shares the verify
# service and QC lane, so they share the span surface too; per-node
# stages carry node= in each record)
_recorder = SpanRecorder()


def recorder() -> SpanRecorder:
    return _recorder


def configure(node_id: str, path: Optional[str] = None) -> None:
    _recorder.configure(node_id, path)


def record(stage: str, dur: float, **kw) -> None:
    _recorder.record(stage, dur, **kw)


def emit(doc: Dict[str, Any]) -> None:
    _recorder.emit(doc)


def recent(limit: int = 256) -> List[Dict[str, Any]]:
    return _recorder.recent(limit)


def snapshot() -> Dict[str, Any]:
    return _recorder.snapshot()
