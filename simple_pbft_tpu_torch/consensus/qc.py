"""Quorum-certificate helpers: share signing, aggregation, cached verify,
and the off-loop batched verify lane.

The QC path (config.qc_mode, BASELINE config 4) moves vote traffic from
O(n^2) all-to-all broadcast to O(n): replicas BLS-sign the phase payload
and send the share to the primary only; the primary aggregates 2f+1
shares into one ``QuorumCert`` whose pairing check certifies the whole
phase. This module owns the share/aggregate/verify mechanics so the
replica runtime stays protocol-shaped.

Verification results are memoized process-wide, keyed by the full
(payload, signer set, aggregate) triple — deterministic, so sharing the
memo across in-process replicas is sound, and a 256-node simulated
committee pays each pairing once instead of once per replica.

``QcVerifyLane`` is the runtime's verify path: a
dedicated worker thread with a bounded admission queue that coalesces
every replica's pending certificate checks into ONE random-linear-
combination multi-pairing (bls.verify_aggregates_batch — 2 Miller loops
per batch instead of 2 per cert). Before the lane, each check rode
``asyncio.to_thread`` into the default executor: at n=256 a 25-60 ms
pairing per cert serialized against the Ed25519 dispatcher's worker
threads and the drain sweep (a wedge with zero commits). The lane keeps certificate crypto off both the event loop
and the shared executor, and its counters (queue depth, batch size,
pairing latency) feed the telemetry plane.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

from .. import devledger, sanitize, spans
from ..crypto import bls
from ..messages import QuorumCert, qc_payload

# Vote QCs drive instance transitions; "checkpoint" certs attest state
# digests (view pinned to 0 in the payload — checkpoints are
# view-independent) and travel ONLY inside view-change certificates.
# Routing guards use VOTE_PHASES so the two sets cannot drift.
VOTE_PHASES = ("prepare", "commit")
PHASES = VOTE_PHASES + ("checkpoint",)

_CACHE_MAX = 4096
_cache: "OrderedDict[tuple, bool]" = OrderedDict()
_cache_lock = sanitize.wrap_lock(threading.Lock(), "qc.cache")
# key -> Event for a pairing currently being computed: concurrent callers
# of the same certificate (every backup receives the primary's broadcast
# at once) wait for the first computation instead of redundantly burning
# ~0.8 s of CPU each — the memo's once-per-process promise, made true
# under concurrency as well.
_inflight: Dict[tuple, threading.Event] = {}


def sign_share(bls_sk: int, phase: str, view: int, seq: int, digest: str) -> str:
    """One replica's BLS share over the QC payload, hex for the wire."""
    return bls.sign(bls_sk, qc_payload(phase, view, seq, digest)).hex()


def share_valid_shape(share_hex: str) -> bool:
    """Cheap structural check (hex, curve point) — NOT a signature check;
    the aggregate pairing (or failure bisection) is the authority."""
    try:
        raw = bytes.fromhex(share_hex)
    except ValueError:
        return False
    return bls._g1_from_bytes(raw) is not None


def build_qc(
    phase: str,
    view: int,
    seq: int,
    digest: str,
    shares: Dict[str, str],
    quorum: int,
) -> Optional[QuorumCert]:
    """Aggregate `quorum` shares (signer -> hex share) into a QuorumCert.
    Callers verify the result before broadcasting (a Byzantine share
    corrupts the aggregate; see bisect_bad_shares)."""
    signers = sorted(shares)[:quorum] if len(shares) >= quorum else None
    if signers is None:
        return None
    try:
        raws = [bytes.fromhex(shares[s]) for s in signers]
    except ValueError:
        return None
    agg = bls.aggregate_signatures(raws)
    if agg is None:
        return None
    return QuorumCert(
        phase=phase,
        view=view,
        seq=seq,
        digest=digest,
        signers=list(signers),
        agg_sig=agg.hex(),
    )


def _qc_entry(cfg, qc: QuorumCert) -> Optional[Tuple[List[bytes], bytes, bytes]]:
    """Structural admission shared by every verify path (sync, lane,
    certificate batch): phase, signer set, pubkey resolution, aggregate
    decode. Returns (pubkeys, payload, aggregate bytes) or None —
    keeping this single-sourced means the lane and the sync path can
    never drift in what they reject."""
    if qc.phase not in PHASES:
        return None
    if len(qc.signers) < cfg.quorum or len(set(qc.signers)) != len(qc.signers):
        return None
    pks: List[bytes] = []
    for s in qc.signers:
        pk = cfg.bls_pubkey(s)
        if pk is None:
            return None
        pks.append(pk)
    try:
        agg = bytes.fromhex(qc.agg_sig)
    except ValueError:
        return None
    return pks, qc.payload(), agg


def _cache_key(qc: QuorumCert) -> tuple:
    return (qc.payload(), tuple(qc.signers), qc.agg_sig)


def cached_verdict(qc: QuorumCert) -> Optional[bool]:
    """Memoized verdict for a certificate, or None when never computed."""
    key = _cache_key(qc)
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None:
            _cache.move_to_end(key)
        return hit


def _cache_store(key: tuple, verdict: bool) -> None:
    with _cache_lock:
        _cache[key] = verdict
        while len(_cache) > _CACHE_MAX:
            _cache.popitem(last=False)


def verify_qc(cfg, qc: QuorumCert) -> bool:
    """Full certificate check: structure, signer set, one pairing.
    Pairing-expensive (25-60 ms native, ~0.8 s pure Python) — run
    off-loop (the runtime path is QcVerifyLane, which also batches);
    results are memoized process-wide."""
    ent = _qc_entry(cfg, qc)
    if ent is None:
        return False
    pks, payload, agg = ent
    key = (payload, tuple(qc.signers), qc.agg_sig)
    while True:
        with _cache_lock:
            hit = _cache.get(key)
            if hit is not None:
                _cache.move_to_end(key)
                return hit
            waiter = _inflight.get(key)
            if waiter is None:
                _inflight[key] = threading.Event()
                break
        waiter.wait()  # another thread is computing this exact pairing
    ok: Optional[bool] = None
    try:
        # pbftlint: disable=PBL001 -- loop residency only via verify_qc_async's clock.simulated() branch (sim-only by contract); every production caller runs in the lane worker or an executor thread
        ok = bls.verify_aggregate(pks, payload, agg)
    finally:
        with _cache_lock:
            ev = _inflight.pop(key, None)
            if ok is not None:  # None = exception: waiters recompute
                _cache[key] = ok
                while len(_cache) > _CACHE_MAX:
                    _cache.popitem(last=False)
        if ev is not None:
            ev.set()
    return ok


def bisect_bad_shares(
    cfg, phase: str, view: int, seq: int, digest: str, shares: Dict[str, str]
) -> Dict[str, str]:
    """Aggregate failed its pairing: verify each share individually and
    return only the good ones. Costs one pairing per share — only runs
    when a Byzantine replica actually sent a corrupt share, and each bad
    signer is then excluded by the caller, bounding the total damage to f
    bisections."""
    payload = qc_payload(phase, view, seq, digest)
    good: Dict[str, str] = {}
    for signer, share_hex in shares.items():
        pk = cfg.bls_pubkey(signer)
        if pk is None:
            continue
        try:
            raw = bytes.fromhex(share_hex)
        except ValueError:
            continue
        if bls.verify(pk, payload, raw):
            good[signer] = share_hex
    return good


def verify_qcs_all(cfg, qcs: List[QuorumCert]) -> bool:
    """All-or-nothing batched check for the quorum certs embedded in ONE
    view-change-class certificate: memoized certs answer from the cache,
    the rest ride one RLC batch (bls.verify_aggregates_all). On batch
    failure nothing is memoized (a combined check cannot attribute
    blame) and the certificate is rejected — a Byzantine certificate
    stuffed with fabricated aggregates costs one batch check, preserving
    the old sequential path's early-exit DoS bound. Pairing-expensive:
    run off-loop."""
    fresh: List[QuorumCert] = []
    entries: List[tuple] = []
    for cert in qcs:
        hit = cached_verdict(cert)
        if hit is False:
            return False
        if hit is True:
            continue
        ent = _qc_entry(cfg, cert)
        if ent is None:
            return False
        fresh.append(cert)
        entries.append(ent)
    if not entries:
        return True
    if not bls.verify_aggregates_all(entries):
        return False
    for cert in fresh:
        _cache_store(_cache_key(cert), True)
    return True


# ---------------------------------------------------------------------------
# Off-loop QC verify lane
# ---------------------------------------------------------------------------


class QcLaneOverloaded(RuntimeError):
    """Admission-rejected QC submit: the lane's pending pile is at cap.

    Raised (as the future's exception) instead of queueing when the
    pending certificate count is at ``max_pending`` — under sustained
    submit-rate > pairing-rate an unbounded lane queue reproduces the r5
    qc256 wedge one layer up. Callers shed the certificate; QCs are
    self-certifying and re-arrive via the primary's broadcast, relays,
    or the slot-probe chain."""


class _LaneEntry:
    __slots__ = ("key", "pks", "payload", "agg", "futs", "t_enq")

    def __init__(self, key, pks, payload, agg, fut):
        self.key = key
        self.pks = pks
        self.payload = payload
        self.agg = agg
        self.futs = [fut]
        self.t_enq = time.perf_counter()  # lane queue-wait span anchor


class QcVerifyLane:
    """Dedicated certificate-verify executor: bounded queue, batch-close
    coalescing, RLC multi-pairing, process-wide memo integration.

    One daemon worker owns all pairing work, so a 60 ms aggregate check
    can never starve the Ed25519 dispatcher's threads or the event loop
    (the r5 qc256 failure shape). Concurrent submissions of the same
    certificate (every backup receives the primary's broadcast at once)
    join the same entry — one pairing, many futures. ``close_window``
    is the batch-close policy: after the first pending cert the worker
    waits that long for the rest of the burst before cutting a batch,
    trading ~2 ms of latency for 2-Miller-loop batches under load.
    """

    def __init__(
        self,
        max_pending: int = 512,
        max_batch: int = 32,
        close_window: float = 0.002,
    ):
        self._max_pending = max_pending
        self._max_batch = max_batch
        self._close_window = close_window
        self._cond = threading.Condition(
            sanitize.wrap_lock(threading.Lock(), "qc.lane.cond")
        )
        self._pending: "OrderedDict[tuple, _LaneEntry]" = OrderedDict()
        self._inflight_entries: Dict[tuple, _LaneEntry] = {}
        self._closed = False
        self._started = False
        # observability (telemetry.py / pbft_top / bench_consensus)
        self.submitted = 0
        self.cache_hits = 0
        self.dedup_joins = 0
        self.structural_rejects = 0
        self.overload_rejections = 0
        self.batches = 0
        self.batch_items = 0
        self.max_batch_seen = 0
        self.rlc_batches = 0
        self.batch_fallbacks = 0
        self.verified_true = 0
        self.verified_false = 0
        self.max_pending_seen = 0
        self._pairing_ms_ema = 0.0
        self.last_batch_ms = 0.0
        self.last_batch_items = 0

    # -- submission -----------------------------------------------------

    def submit(self, cfg, qc: QuorumCert) -> "Future[bool]":
        """Enqueue one certificate check; the future resolves to its
        verdict. Never blocks; never runs a pairing on the caller's
        thread (memo hits and structural rejects resolve inline)."""
        fut: Future = Future()
        self.submitted += 1
        hit = cached_verdict(qc)
        if hit is not None:
            self.cache_hits += 1
            fut.set_result(hit)
            return fut
        ent = _qc_entry(cfg, qc)
        if ent is None:
            self.structural_rejects += 1
            fut.set_result(False)
            return fut
        pks, payload, agg = ent
        key = (payload, tuple(qc.signers), qc.agg_sig)
        closed = False
        with self._cond:
            closed = self._closed
            if not closed:
                joined = self._pending.get(key) or self._inflight_entries.get(key)
                if joined is not None:
                    joined.futs.append(fut)
                    self.dedup_joins += 1
                    return fut
                if len(self._pending) >= self._max_pending:
                    self.overload_rejections += 1
                    fut.set_exception(
                        QcLaneOverloaded(
                            f"qc verify lane overloaded: {len(self._pending)} "
                            f"certs pending (cap {self._max_pending})"
                        )
                    )
                    return fut
                self._pending[key] = _LaneEntry(key, pks, payload, agg, fut)
                if len(self._pending) > self.max_pending_seen:
                    self.max_pending_seen = len(self._pending)
                if not self._started:
                    self._started = True
                    threading.Thread(
                        target=self._worker, name="qc-verify-lane", daemon=True
                    ).start()
                self._cond.notify_all()
        if closed:
            # teardown race: answer via a one-off worker rather than
            # erroring a certificate already in the pipeline — and never
            # pair on the CALLER's thread (verify_qc_async submits from
            # the event loop, which must not eat a 25-60 ms pairing even
            # during teardown). Memo hits make this near-free in practice.
            def _late() -> None:
                try:
                    fut.set_result(verify_qc(cfg, qc))
                except BaseException as exc:  # noqa: BLE001
                    if not fut.cancelled():
                        fut.set_exception(exc)

            threading.Thread(
                target=_late, name="qc-verify-late", daemon=True
            ).start()
        return fut

    # -- worker ---------------------------------------------------------

    def _take_locked(self) -> List[_LaneEntry]:
        take: List[_LaneEntry] = []
        while self._pending and len(take) < self._max_batch:
            _, ent = self._pending.popitem(last=False)
            take.append(ent)
            self._inflight_entries[ent.key] = ent
        return take

    def _worker(self) -> None:
        sanitize.bind_owner(("qc.lane.worker", id(self)), "QcVerifyLane._worker")
        try:
            while True:
                with self._cond:
                    while not self._pending and not self._closed:
                        self._cond.wait()
                    if self._closed and not self._pending:
                        return
                    if (
                        self._close_window > 0
                        and not self._closed
                        and len(self._pending) < self._max_batch
                    ):
                        # batch-close: let the rest of a broadcast burst land
                        self._cond.wait(self._close_window)
                    take = self._take_locked()
                if take:
                    self._run_batch(take)
        finally:
            # a later lane at this recycled id() must bind fresh
            sanitize.release_owner(("qc.lane.worker", id(self)))

    def _run_batch(self, take: List[_LaneEntry]) -> None:
        # pairing work is confined to the lane worker: a pairing on any
        # other thread (the loop!) is exactly the r5 wedge shape
        sanitize.check_owner(("qc.lane.worker", id(self)), "QcVerifyLane._run_batch")
        t0 = time.perf_counter()
        for e in take:
            # lane wait per certificate: submit -> batch start (includes
            # the deliberate ~2 ms close window — that policy cost must
            # be visible in the decomposition, not folded into "pairing")
            spans.record(spans.QC_QUEUE, t0 - e.t_enq, n=len(e.futs))
        try:
            verdicts = bls.verify_aggregates_batch(
                [(e.pks, e.payload, e.agg) for e in take]
            )
        except BaseException as exc:  # noqa: BLE001 — futures must resolve
            with self._cond:
                futs = []
                for e in take:
                    self._inflight_entries.pop(e.key, None)
                    futs.extend(e.futs)
            for fut in futs:
                if not fut.cancelled():
                    fut.set_exception(exc)
            return
        dt_ms = (time.perf_counter() - t0) * 1e3
        spans.record(spans.QC_PAIRING, dt_ms / 1e3, n=len(take))
        # device-ledger event for the BLS pairing lane: same
        # schema as the Ed25519 jit dispatches — one row per RLC batch,
        # queue wait = mean lane wait, bytes_up = the certificate
        # material the pairing consumed (payloads + aggregates + 96 B
        # per signer pubkey). No jit here, so compile is always cached.
        devledger.record(
            devledger.LANE_BLS, "pairing", 0, len(take), len(take),
            rtt_s=dt_ms / 1e3,
            queue_wait_s=(
                sum(t0 - e.t_enq for e in take) / len(take) if take else 0.0
            ),
            submissions=len(take),
            bytes_up=sum(
                len(e.payload) + len(e.agg) + 96 * len(e.pks) for e in take
            ),
            bytes_down=len(take),
        )
        self.batches += 1
        self.batch_items += len(take)
        self.max_batch_seen = max(self.max_batch_seen, len(take))
        self.last_batch_ms = dt_ms
        self.last_batch_items = len(take)
        self._pairing_ms_ema = (
            dt_ms if self._pairing_ms_ema == 0.0
            else 0.8 * self._pairing_ms_ema + 0.2 * dt_ms
        )
        if len(take) > 1:
            self.rlc_batches += 1
            if not all(verdicts):
                self.batch_fallbacks += 1  # halving/per-cert path ran
        for e, ok in zip(take, verdicts):
            _cache_store(e.key, ok)
            if ok:
                self.verified_true += 1
            else:
                self.verified_false += 1
            with self._cond:
                self._inflight_entries.pop(e.key, None)
                futs = list(e.futs)
            for fut in futs:
                if not fut.cancelled():
                    fut.set_result(ok)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def snapshot(self) -> dict:
        """QC-lane counters for the telemetry plane."""
        with self._cond:
            pending = len(self._pending)
            inflight = len(self._inflight_entries)
        return {
            "pending": pending,
            "inflight": inflight,
            "max_pending": self._max_pending,
            "max_pending_seen": self.max_pending_seen,
            "submitted": self.submitted,
            "cache_hits": self.cache_hits,
            "dedup_joins": self.dedup_joins,
            "structural_rejects": self.structural_rejects,
            "overload_rejections": self.overload_rejections,
            "batches": self.batches,
            "batch_items": self.batch_items,
            "batch_mean": (
                round(self.batch_items / self.batches, 2) if self.batches else 0.0
            ),
            "max_batch_seen": self.max_batch_seen,
            "rlc_batches": self.rlc_batches,
            "batch_fallbacks": self.batch_fallbacks,
            "verified_true": self.verified_true,
            "verified_false": self.verified_false,
            "pairing_ms_ema": round(self._pairing_ms_ema, 3),
            "last_batch_ms": round(self.last_batch_ms, 3),
            "last_batch_items": self.last_batch_items,
        }


_lane_lock = sanitize.wrap_lock(threading.Lock(), "qc.lane_registry")
_lane: Optional[QcVerifyLane] = None


def qc_lane() -> QcVerifyLane:
    """The process-wide lane (lazily created): every in-process replica
    shares it, so concurrent replicas' certificate checks coalesce into
    the same RLC batches — the same sharing shape as the coalescing
    Ed25519 VerifyService."""
    global _lane
    with _lane_lock:
        if _lane is None:
            _lane = QcVerifyLane()
        return _lane


def lane_snapshot() -> Optional[dict]:
    """Snapshot of the process lane, or None when no QC was ever
    submitted (non-QC committees pay nothing for the lane existing)."""
    with _lane_lock:
        return _lane.snapshot() if _lane is not None else None


async def verify_qc_async(cfg, qc: QuorumCert) -> bool:
    """The runtime's certificate check: submit to the lane and await the
    batched verdict off-loop. Raises QcLaneOverloaded when the lane's
    admission queue is at cap (callers shed; the cert re-arrives).

    Under simulation (simple_pbft_tpu/sim.py) the pairing runs INLINE:
    the lane's worker thread completes in wall time, which a virtual
    clock outruns arbitrarily — every downstream interleaving would
    race it. Loop-blocking is harmless there (nothing real-time shares
    a simulated loop), and the verdict memo keeps the cost one pairing
    per distinct certificate either way."""
    import asyncio

    from .. import clock

    if clock.simulated():
        # pbftlint: disable=PBL001 -- sim-only branch: clock.simulated() gates it off every production loop; blocking a simulated loop is the determinism contract, not a stall
        return verify_qc(cfg, qc)
    return await asyncio.wrap_future(qc_lane().submit(cfg, qc))
