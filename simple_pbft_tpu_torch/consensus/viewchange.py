"""View change: primary failover with VIEW-CHANGE / NEW-VIEW certificates.

The reference never implemented this — its ``view.go`` is dead code
(SURVEY.md §2 item 8: round-robin primary sketched, never called), and its
author's notes (需要改进的地方.md:40-69) specify VIEW-CHANGE / NEW-VIEW as
the largest missing piece. This module implements the Castro-Liskov
protocol:

- A backup with outstanding work arms a timer; on expiry it stops
  participating in view v and broadcasts VIEW-CHANGE(v+1, h, C, P): its
  stable checkpoint h, the 2f+1 checkpoint certificate C proving h, and a
  prepared certificate P (pre-prepare + 2f+1 prepares) for every seq > h
  it had prepared.
- If a replica sees f+1 VIEW-CHANGEs for views above its own, it joins
  the lowest such view immediately (liveness: don't wait for your own
  timer once the committee is moving).
- The new view's primary, on 2f+1 VIEW-CHANGEs, broadcasts
  NEW-VIEW(v', V, O): the view-change certificate V and the re-issued
  pre-prepares O — for every seq in (h, max_s] the highest-view prepared
  certificate's block, or a no-op block for gaps. O is a deterministic
  function of V, so backups recompute and cross-check it.
- Timers back off exponentially (timeout doubles per failed view) so
  consecutive crashed primaries are skipped in bounded time.

TPU-first consequence: certificates are *batches of signatures* — one
NEW-VIEW carries 2f+1 VIEW-CHANGEs, each holding up to W prepared proofs
of 2f+2 signatures. The replica runtime flattens every nested signature
into the same ``verify_batch`` call as regular traffic, so validating a
view-change storm is a single TPU pass per sweep (BASELINE.md config 5).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import random
import threading
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from .. import clock, trace
from ..crypto.verifier import BatchItem
from ..messages import (
    EMPTY_BLOCK_DIGEST,
    Checkpoint,
    Commit,
    Message,
    NewView,
    PrePrepare,
    Prepare,
    QuorumCert,
    ViewChange,
)
from . import qc as qc_mod

log = logging.getLogger("pbft.viewchange")

NOOP_BLOCK: List[Dict[str, Any]] = []


# ---------------------------------------------------------------------------
# Certificate structural validation + signature-item collection.
#
# These run BEFORE signature verification: they bound sizes, decode nested
# messages, and emit the BatchItems whose verdicts decide admission. A None
# return means structurally inadmissible (never raises on hostile input).
# ---------------------------------------------------------------------------


def _decode(d: Any, want: type) -> Optional[Message]:
    if not isinstance(d, dict):
        return None
    try:
        # certificate internals: the enclosing wire message was already
        # depth-checked once on arrival (Message.from_wire)
        msg = Message.from_dict(d, _depth_checked=True)
    except ValueError:
        return None
    return msg if isinstance(msg, want) else None


def _sig_item(cfg, msg: Message) -> Optional[BatchItem]:
    pub = cfg.pubkey(msg.sender)
    if pub is None or not msg.sig:
        return None
    try:
        sig = bytes.fromhex(msg.sig)
    except ValueError:
        return None
    return BatchItem(pubkey=pub, msg=msg.signing_payload(), sig=sig)


def validate_prepared_proof(
    cfg, proof: Any, min_seq: int, max_seq: int
) -> Optional[Tuple[PrePrepare, List[Prepare], List[BatchItem], List[QuorumCert]]]:
    """One P-set entry for one seq: {pre_prepare, prepares[2f+1]} — or, in
    QC mode, {pre_prepare, prepare_qc} where the BLS aggregate replaces
    the 2f+1 embedded votes. Returns (pp, prepares, ed25519 items,
    quorum certs still needing their pairing check)."""
    if not isinstance(proof, dict):
        return None
    pp = _decode(proof.get("pre_prepare"), PrePrepare)
    if pp is None or not (min_seq < pp.seq <= max_seq):
        return None
    if pp.sender != cfg.primary(pp.view):
        return None
    # P-set pre-prepares ship DETACHED (block == [], digest binds the
    # content — the signature covers the digest, not the block). A proof
    # that does carry a block must be consistent with its digest.
    if pp.block and PrePrepare.block_digest(pp.block) != pp.digest:
        return None
    items: List[BatchItem] = []
    it = _sig_item(cfg, pp)
    if it is None:
        return None
    items.append(it)

    if "prepare_qc" in proof:
        if not cfg.qc_mode:
            return None
        cert = _decode(proof.get("prepare_qc"), QuorumCert)
        if cert is None or cert.phase != "prepare":
            return None
        if (cert.view, cert.seq, cert.digest) != (pp.view, pp.seq, pp.digest):
            return None
        if len(cert.signers) < cfg.quorum or len(set(cert.signers)) != len(
            cert.signers
        ):
            return None
        if any(s not in cfg.replica_ids for s in cert.signers):
            return None
        # the aggregate IS the certificate: no per-vote ed25519 items;
        # the pairing check runs off-loop on the returned cert
        return pp, [], items, [cert]

    raw_prepares = proof.get("prepares")
    if not isinstance(raw_prepares, list) or len(raw_prepares) > cfg.n:
        return None
    prepares: List[Prepare] = []
    senders = set()
    for rd in raw_prepares:
        p = _decode(rd, Prepare)
        if p is None or p.sender in senders or p.sender not in cfg.replica_ids:
            return None
        if (p.view, p.seq, p.digest) != (pp.view, pp.seq, pp.digest):
            return None
        senders.add(p.sender)
        it = _sig_item(cfg, p)
        if it is None:
            return None
        items.append(it)
        prepares.append(p)
    if len(prepares) < cfg.quorum:
        return None
    return pp, prepares, items, []


def validate_view_change(
    cfg, msg: ViewChange, current_view_floor: int = 0
) -> Optional[Tuple[Dict[int, Tuple[PrePrepare, List[Prepare]]], List[Checkpoint], List[BatchItem], List[QuorumCert]]]:
    """Structural check of one VIEW-CHANGE; returns (prepared-by-seq,
    checkpoint proof msgs, nested ed25519 sig items, quorum certs whose
    pairing checks the caller must still run) or None."""
    if msg.sender not in cfg.replica_ids:
        return None
    if msg.new_view <= current_view_floor:
        return None
    if msg.stable_seq < 0:
        return None
    items: List[BatchItem] = []
    qcs: List[QuorumCert] = []
    # checkpoint certificate for h (h = 0 needs no proof: genesis)
    cps: List[Checkpoint] = []
    if msg.stable_seq > 0:
        if not isinstance(msg.checkpoint_proof, list) or len(msg.checkpoint_proof) > cfg.n:
            return None
        cp_qc = (
            _decode(msg.checkpoint_proof[0], QuorumCert)
            if cfg.qc_mode and len(msg.checkpoint_proof) == 1
            else None
        )
        if cp_qc is not None:
            # QC form: one aggregate over ("checkpoint", 0, h, digest)
            if cp_qc.phase != "checkpoint" or cp_qc.seq != msg.stable_seq:
                return None
            if cp_qc.view != 0:
                return None
            if len(cp_qc.signers) < cfg.quorum or len(set(cp_qc.signers)) != len(
                cp_qc.signers
            ):
                return None
            if any(s not in cfg.replica_ids for s in cp_qc.signers):
                return None
            qcs.append(cp_qc)  # pairing check runs with the other certs
        else:
            senders = set()
            digests = set()
            for rd in msg.checkpoint_proof:
                cp = _decode(rd, Checkpoint)
                if cp is None or cp.seq != msg.stable_seq:
                    return None
                if cp.sender in senders or cp.sender not in cfg.replica_ids:
                    return None
                senders.add(cp.sender)
                digests.add(cp.state_digest)
                it = _sig_item(cfg, cp)
                if it is None:
                    return None
                items.append(it)
                cps.append(cp)
            if len(cps) < cfg.quorum or len(digests) != 1:
                return None
    if not isinstance(msg.prepared_proofs, list):
        return None
    if len(msg.prepared_proofs) > cfg.watermark_window:
        return None
    prepared: Dict[int, Tuple[PrePrepare, List[Prepare]]] = {}
    for proof in msg.prepared_proofs:
        res = validate_prepared_proof(
            cfg, proof, msg.stable_seq, msg.stable_seq + cfg.watermark_window
        )
        if res is None:
            return None
        pp, prepares, pitems, pqcs = res
        if pp.seq in prepared or pp.view >= msg.new_view:
            return None
        prepared[pp.seq] = (pp, prepares)
        items.extend(pitems)
        qcs.extend(pqcs)
    return prepared, cps, items, qcs


def compute_o_set(
    cfg, vcs: Dict[str, ViewChange], new_view: int
) -> Tuple[int, List[Tuple[int, str]]]:
    """Deterministic O-set from a view-change certificate: returns
    (h, [(seq, digest), ...]) for seq in (h, max_s], highest-view
    prepared certificate winning, the no-op digest for gaps. Blocks are
    NOT part of O — certificates are digest-only; receivers refill
    blocks from their store or BlockFetch at install.

    Callers pass only structurally-validated, signature-verified VCs.
    """
    h = max((vc.stable_seq for vc in vcs.values()), default=0)
    best: Dict[int, Tuple[int, str]] = {}
    for vc in vcs.values():
        for proof in vc.prepared_proofs:
            pp = _decode(proof.get("pre_prepare"), PrePrepare)
            if pp is None or pp.seq <= h:
                continue
            cur = best.get(pp.seq)
            if cur is None or pp.view > cur[0]:
                best[pp.seq] = (pp.view, pp.digest)
    max_s = max(best, default=h)
    out = []
    for seq in range(h + 1, max_s + 1):
        if seq in best:
            out.append((seq, best[seq][1]))
        else:
            out.append((seq, EMPTY_BLOCK_DIGEST))
    return h, out


def dedup_checkpoint_proofs(
    vcs: "List[ViewChange]",
) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """NEW-VIEW assembly: strip each embedded VIEW-CHANGE's checkpoint
    proof into a shared pool keyed by stable_seq — 2f+1 replicas proving
    the same h (the common case; checkpoint certificates are committee-
    wide objects) then ship ONE copy instead of 2f+1 (VERDICT weak #5).
    Sound because ViewChange.signing_payload detaches the proof.
    Returns (stripped vc dicts, pool entries)."""
    pool: Dict[int, List[Dict[str, Any]]] = {}
    stripped: List[Dict[str, Any]] = []
    for vc in vcs:
        d = vc.to_dict()
        if vc.stable_seq > 0 and vc.checkpoint_proof:
            # first proof for an h wins: all valid proofs of the same h
            # are interchangeable (any 2f+1 matching certificate serves)
            pool.setdefault(vc.stable_seq, vc.checkpoint_proof)
            d["checkpoint_proof"] = []  # top-level key: safe to adjust
        stripped.append(d)
    return stripped, [
        {"seq": s, "proof": p} for s, p in sorted(pool.items())
    ]


# The port's one edit to this module: validate_new_view is memoised per
# process. Its result is a pure function of the committee config and the
# message's content, and every replica of an in-process committee (the
# benches' and the smoke's) receives the same NEW-VIEW, once from its
# primary and again from each fetch: at n = 64 the JAX package's function
# walks the same multi-megabyte certificate for each of them on the one
# event loop, where here it walks it once. The key is the SHA-256 of the
# message's signing payload (every field but the signature, cached on the
# message, which the sweep has already encoded for the envelope's item)
# and its signature, so a certificate that differs in any field is walked
# anew; a hit needs the same config object. The cached result is shared,
# as the JAX package's is within one replica: callers read it.
_NV_MEMO: "OrderedDict[bytes, Tuple[Any, Any]]" = OrderedDict()
_NV_MEMO_MAX = 4
_NV_MEMO_LOCK = threading.Lock()


def validate_new_view(
    cfg, msg: NewView
) -> Optional[Tuple[Dict[str, ViewChange], List[BatchItem], List[QuorumCert]]]:
    """Structural check of NEW-VIEW: the 2f+1 VC certificate plus the
    re-issued pre-prepares, which must equal the recomputed O-set.
    Returns (vcs, ed25519 items, pending quorum-cert pairing checks)."""
    key = hashlib.sha256(msg.signing_payload() + msg.sig.encode()).digest()
    with _NV_MEMO_LOCK:
        hit = _NV_MEMO.get(key)
        if hit is not None and hit[0] is cfg:
            _NV_MEMO.move_to_end(key)
            return hit[1]
    res = _validate_new_view(cfg, msg)
    with _NV_MEMO_LOCK:
        _NV_MEMO[key] = (cfg, res)
        _NV_MEMO.move_to_end(key)
        while len(_NV_MEMO) > _NV_MEMO_MAX:
            _NV_MEMO.popitem(last=False)
    return res


def _validate_new_view(
    cfg, msg: NewView
) -> Optional[Tuple[Dict[str, ViewChange], List[BatchItem], List[QuorumCert]]]:
    """validate_new_view's walk."""
    if msg.sender != cfg.primary(msg.new_view):
        return None
    if not isinstance(msg.viewchange_proof, list) or len(msg.viewchange_proof) > cfg.n:
        return None
    # shared checkpoint-certificate pool (see dedup_checkpoint_proofs):
    # bounded, one entry per distinct h, each proof re-bounded by
    # validate_view_change after refill
    if not isinstance(msg.checkpoint_pool, list) or len(msg.checkpoint_pool) > cfg.n:
        return None
    pool: Dict[int, List[Any]] = {}
    for entry in msg.checkpoint_pool:
        if not isinstance(entry, dict):
            return None
        seq, proof = entry.get("seq"), entry.get("proof")
        if not isinstance(seq, int) or isinstance(seq, bool) or seq <= 0:
            return None
        if not isinstance(proof, list) or len(proof) > cfg.n or seq in pool:
            return None
        pool[seq] = proof
    pool_unclaimed = set(pool)  # every entry must back some VC's h
    vcs: Dict[str, ViewChange] = {}
    items: List[BatchItem] = []
    qcs: List[QuorumCert] = []
    for rd in msg.viewchange_proof:
        vc = _decode(rd, ViewChange)
        if vc is None or vc.new_view != msg.new_view or vc.sender in vcs:
            return None
        if vc.stable_seq > 0 and not vc.checkpoint_proof:
            # refill from the pool; the envelope signature still holds
            # (the proof is detached from it), and validate_view_change
            # re-checks the refilled proof like an inline one. A missing
            # pool entry leaves the proof empty and the VC rejects below.
            refill = pool.get(vc.stable_seq)
            if refill is not None:
                vc.checkpoint_proof = refill
                # claimed AND consumed: the refilled proof goes through
                # validate_view_change below like an inline one — only
                # this makes a pool entry legitimate (an entry consumed
                # by no stripped VC would be unvalidated dead weight)
                pool_unclaimed.discard(vc.stable_seq)
        res = validate_view_change(cfg, vc)
        if res is None:
            return None
        _, _, vitems, vqcs = res
        it = _sig_item(cfg, vc)
        if it is None:
            return None
        items.append(it)
        items.extend(vitems)
        qcs.extend(vqcs)
        vcs[vc.sender] = vc
    if len(vcs) < cfg.quorum:
        return None
    if pool_unclaimed:
        # entries no embedded VC claims are unvalidated dead weight a
        # Byzantine primary could pad toward the wire cap — reject
        return None
    # O must be exactly the deterministic function of V (digest-only;
    # re-issued pre-prepares ship detached — blocks resolve at install,
    # where the digest check makes substitution impossible. Client
    # signatures inside blocks were verified at original admission, and
    # every O-set digest is backed by a prepared certificate from at
    # least f+1 honest replicas that performed that check.)
    _, o_set = compute_o_set(cfg, vcs, msg.new_view)
    if not isinstance(msg.pre_prepares, list) or len(msg.pre_prepares) != len(o_set):
        return None
    for rd, (seq, digest) in zip(msg.pre_prepares, o_set):
        pp = _decode(rd, PrePrepare)
        if pp is None:
            return None
        if (pp.view, pp.seq, pp.digest) != (msg.new_view, seq, digest):
            return None
        if pp.block or pp.sender != msg.sender:
            return None  # re-issues are always detached
        it = _sig_item(cfg, pp)
        if it is None:
            return None
        items.append(it)
    return vcs, items, qcs


# ---------------------------------------------------------------------------
# Runtime side: timers + protocol driver, owned by a Replica
# ---------------------------------------------------------------------------


class ViewChanger:
    """Per-replica view-change state machine.

    Owns the failover timer and the VIEW-CHANGE/NEW-VIEW exchange; calls
    back into the replica for transport, signing, and instance adoption.
    """

    # bound on how far ahead of the current view VIEW-CHANGEs are tracked
    # (honest backoff walks one view at a time; anything further is a
    # Byzantine memory-growth vector)
    MAX_VIEWS_AHEAD = 128

    # Dead-target fast-path (the search-found failover
    # tail). A candidate view's primary is EVIDENCE-DEAD when
    # it has been silent for this many view timeouts WHILE at least
    # f other peers were heard inside the same window — the asymmetry
    # (everyone else loud, this one mute) is what distinguishes a
    # crashed peer from our own partition or an idle committee, so the
    # fast-path can never fire when WE are the cut-off ones. Floor and
    # cap keep the window sane at extreme timeout configs.
    DEAD_SILENCE_FACTOR = 2.0
    DEAD_SILENCE_FLOOR = 1.0
    DEAD_SILENCE_CAP = 30.0

    def __init__(self, replica) -> None:
        self.r = replica
        self.in_view_change = False
        self.target_view = replica.view
        # view -> sender -> full validated ViewChange at that view's
        # primary; None at backups (sender presence is all the join rule
        # and quorum counting need — see on_view_change)
        self.vc_store: Dict[int, Dict[str, Optional[ViewChange]]] = {}
        self.new_view_sent: set = set()
        self._timer: Optional[asyncio.TimerHandle] = None
        self._probe_timer: Optional[asyncio.TimerHandle] = None
        # Strong refs to EVERY in-flight fire-and-forget task. A single
        # overwritable slot loses the reference to a still-suspended
        # predecessor (e.g. a start_view_change parked on the checkpoint
        # QC pairing under load when the next expiry fires) — the
        # collector may then destroy the pending task, leaving the
        # replica frozen (in_view_change set) with its VIEW-CHANGE never
        # broadcast and no exception anywhere. Measured as the n=64
        # chaos wedge: 40 replicas "at target 2", 5 VCs in the new
        # primary's store.
        self._bg_tasks: set = set()
        self._timeout = replica.cfg.view_timeout
        # Deterministic per-replica jitter for every failover timer: a
        # committee-wide stall (e.g. a checkpoint pause) otherwise expires
        # every replica's timer in the same instant, and the synchronized
        # VIEW-CHANGE waves + resends congest the pipeline faster than
        # any target's certificate can complete (the measured n=64
        # congestion-collapse wedge). +-20% decorrelates the waves.
        # content-stable seed: str hash() is salted per process, which
        # would make jitter (and so failover trajectories) irreproducible
        # from a bench seed
        self._rng = random.Random(zlib.crc32(replica.id.encode()))
        self._nv_granted: set = set()  # views granted a NEW-VIEW window
        # failover deferral (see _expired): progress markers at arm time
        # and the backlog head at the last deferral
        self._armed_exec = -1
        self._armed_committed = -1
        self._deferred_key = None
        # executed_seq at the previous probe tick: vote retransmission
        # fires only when two consecutive ticks see no progress
        self._probe_last_exec = -1
        self._target_expiries = 0  # expiries while frozen at one target
        self._last_target_support = -1  # store size at the last expiry
        # highest view seen in signature-verified traffic (bounded by
        # MAX_VIEWS_AHEAD) — evidence a NEW-VIEW we never received exists
        self._view_hint = 0
        self._hint_fetches = 0

    # -- timers ---------------------------------------------------------

    def _jitter(self, t: float) -> float:
        return t * self._rng.uniform(0.8, 1.2)

    def arm(self) -> None:
        """Arm the failover timer if not already armed (called whenever a
        request is outstanding). A recovery PROBE fires at half the
        timeout: a stalled slot (dropped QC or pre-prepare — execution
        is sequential, so one hole blocks a replica forever) then heals
        with one SlotFetch round trip instead of a view change."""
        if self._timer is None and self.r.cfg.view_timeout > 0:
            loop = asyncio.get_running_loop()
            self._armed_exec = self.r.executed_seq
            self._armed_committed = self.r.max_committed_seen
            self._timer = loop.call_later(self._jitter(self._timeout), self._expired)
            if self._probe_timer is None:
                # repair cadence is CAPPED, not tied to the backoff
                # ladder: a backed-off failover timer (up to 60 s) must
                # not stretch probe/vote-resend intervals to 30 s — the
                # stall those repairs exist for is exactly when the
                # ladder is high (seed-99 chaos tail: frontier commit
                # shares stuck 38/43 while probes slept out the backoff)
                self._probe_timer = loop.call_later(
                    self._jitter(min(max(0.5, self._timeout / 2), 3.0)),
                    self._probe,
                )

    def reset(self) -> None:
        """Progress was made: reset the backoff, re-arm if work remains."""
        self._timeout = self.r.cfg.view_timeout  # progress resets backoff
        self._rearm_only()

    def _rearm_only(self) -> None:
        """Re-arm at the CURRENT (possibly backed-off) timeout without
        treating the event as progress."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self.r.has_outstanding_work():
            self.arm()

    def cancel(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self._probe_timer is not None:
            self._probe_timer.cancel()
            self._probe_timer = None

    def ensure_probe(self) -> None:
        """Start the repair-probe chain if it is idle. Called whenever a
        block parks in `ready` behind an execution hole: hole repair must
        not depend on the FAILOVER timer being armed (a backup that
        relays no client work never arms it, yet can still lose frames —
        and arming failover on local holes causes join cascades)."""
        if self._probe_timer is None and self.r.cfg.view_timeout > 0:
            # same cadence cap as arm()/_probe: the first repair probe
            # must not sleep out a backed-off failover ladder
            self._probe_timer = asyncio.get_running_loop().call_later(
                self._jitter(min(max(0.25, self._timeout / 4), 3.0)),
                self._probe,
            )

    def _spawn(self, coro) -> None:
        """Launch a fire-and-forget coroutine with a retained reference
        and consumed exception (see _bg_tasks above)."""
        task = asyncio.ensure_future(coro)
        self._bg_tasks.add(task)

        def _done(t: asyncio.Task) -> None:
            self._bg_tasks.discard(t)
            if not t.cancelled() and t.exception() is not None:
                log.error(
                    "%s: background view-change task failed",
                    self.r.id, exc_info=t.exception(),
                )

        task.add_done_callback(_done)

    def _probe(self) -> None:
        self._probe_timer = None
        # Keep probing WHILE FROZEN in a view change too: a replica whose
        # stall was local (dropped QCs/pre-prepares, not a dead primary)
        # fires a view change the healthy committee never joins — its only
        # way back is catching up in the current view, and execution from
        # commit certificates is final in every view. Before round 4 the
        # in-view-change gate here made such replicas permanently deaf
        # (the qc-n64 chaos near-stall: replica_exec_min = 0).
        if not (
            self.r.has_outstanding_work()
            or self.r.ready
            or self.pending_view_hint()
        ):
            # chain going idle: invalidate the progress marker so the
            # next chain's FIRST tick can never match a stale value and
            # fire vote resends on a healthy pipeline
            self._probe_last_exec = -1
            return
        # retain the task (a bare ensure_future can be collected mid-send)
        self._spawn(self.r.send_slot_probe())
        # vote retransmission fires only when execution made NO progress
        # since the last probe tick: probes fetch artifacts that exist;
        # lost VOTES for the frontier must be re-emitted by their senders
        # or the slot stalls until the view-change ladder outlasts client
        # patience (qc-n64 chaos tail starvation, seed 99). The progress
        # gate keeps healthy pipelines free of redundant vote traffic.
        if self.r.executed_seq == self._probe_last_exec:
            self._spawn(self.r.resend_frontier_votes())
        self._probe_last_exec = self.r.executed_seq
        # keep probing while the stall lasts (the response itself can be
        # dropped); the server side rate-limits per sender. Cadence is
        # capped independently of the failover backoff (see arm()).
        self._probe_timer = asyncio.get_running_loop().call_later(
            self._jitter(min(max(0.5, self._timeout / 2), 3.0)), self._probe
        )

    def _expired(self) -> None:
        self._timer = None
        r = self.r
        if not r.has_outstanding_work():
            return
        # Failover deferral: PBFT's timeout policy assumes a stall means
        # a faulty primary, because the paper's blanket retransmission
        # makes per-replica loss invisible. This framework repairs local
        # loss with targeted slot probes instead — so when EXECUTION HAS
        # ADVANCED since the timer was armed (the committee is live) and
        # the head of our backlog is not stuck (no censorship), a local
        # stall must be repaired, not escalated: unilateral view changes
        # under lossy links synchronize into f+1 join cascades and tear
        # down healthy views (measured at n=64/QC with 2% drop). The
        # same backlog head surviving two consecutive deferrals is the
        # censorship signal that restores the classic escalation: a
        # live committee that will not execute OUR client's request is
        # exactly what a view change exists to fix.
        if not self.in_view_change and (
            r.executed_seq > self._armed_exec
            or r.max_committed_seen > self._armed_committed
        ):
            # A LOCAL stall (execution hole behind observed commits, or
            # parked ready blocks) fully explains a stuck backlog head,
            # so it defers unconditionally — the probes are repairing it,
            # and escalating would punish a live committee for our loss.
            # Otherwise the same head surviving two consecutive deferrals
            # means the live committee will not execute OUR work:
            # censorship, the case the view change exists for.
            stalled_locally = bool(r.ready) or (
                r.executed_seq < r.max_committed_seen
            )
            key = self._backlog_head()
            if stalled_locally or key is None or key != self._deferred_key:
                self._deferred_key = key
                r.metrics["failover_deferred"] += 1
                self.arm()  # re-arm at the current (un-backed-off) timeout
                return
        self._deferred_key = None
        if self.in_view_change:
            self._target_expiries += 1
            # Dead-target fast-path: our target
            # view's primary is evidence-dead — silent for multiples of
            # the timeout while the rest of the committee is loud. A
            # dead primary will never assemble the NEW-VIEW, so
            # retransmitting VIEW-CHANGEs at it is the measured
            # +369..+750 s failover tail (the search-found repro,
            # tests/sim_repros/slow_failover_tail.json): skip straight
            # to escalation, and let next_live_target route past any
            # further dead-primaried views.
            dead_target = self.primary_evidence_dead(self.target_view)
            if dead_target:
                r.metrics["dead_target_fastpath"] += 1
            # "gathering": the target's certificate is visibly STILL
            # FILLING (>= f+1 support and more than at the last expiry).
            # A full-but-static store means the target's primary is dead
            # or hopeless — escalation is then correct (a plain >= f+1
            # check deadlocked the two-dead-primaries cascade: everyone
            # saw support for view 1 forever and nobody walked to 2).
            support = len(self.vc_store.get(self.target_view, {}))
            gathering = (
                support >= r.cfg.weak_quorum
                and support > self._last_target_support
            )
            self._last_target_support = support
            if not dead_target and (
                self._target_expiries % 2 == 1 or gathering
            ):
                # RETRANSMIT for the SAME view instead of escalating:
                # (a) on the first expiry at a target — the broadcast
                # itself is lossy, and unilateral +1 laddering outruns
                # the view the committee actually installs (measured:
                # 486 below-target rejections marooned frozen replicas);
                # (b) whenever we can SEE >= f+1 VIEW-CHANGEs for our
                # target — the committee is gathering; escalating away
                # then guarantees no view ever accumulates 2f+1 at its
                # primary (measured congestion-collapse wedge at n=64:
                # targets 2/3/4 split 49/8/7, every store under quorum).
                r.metrics["view_change_resent"] += 1
                self._timeout = min(self._timeout * 2, 60.0)
                self._timer = asyncio.get_running_loop().call_later(
                    self._jitter(self._timeout), self._expired
                )
                self._spawn(self.resend_view_change())
                return
        self._target_expiries = 0
        # retain the task: a bare ensure_future is only weakly referenced
        # by the loop and can be collected mid-broadcast. The target is
        # the next view whose primary is not evidence-dead (see
        # next_live_target) — the initial expiry and every escalation
        # both route around crashed primaries.
        self._spawn(self.start_view_change(
            self.next_live_target(max(self.target_view, r.view) + 1)
        ))

    def _dead_window(self) -> float:
        base = self.r.cfg.view_timeout
        return min(
            max(self.DEAD_SILENCE_FACTOR * base, self.DEAD_SILENCE_FLOOR),
            self.DEAD_SILENCE_CAP,
        )

    def primary_evidence_dead(self, view: int) -> bool:
        """Is `view`'s primary evidence-dead — silent past the window
        while the committee is audibly alive? Conservative by design:
        never true for ourselves, never true in an idle committee (no
        peer is "recent" there, so the liveness quorum fails), never
        true when we are the partitioned ones (same reason). A wrong
        verdict costs one extra view of rotation, never safety — view
        numbers are coordination, and any replica may join any higher
        view."""
        r = self.r
        pid = r.cfg.primary(view)
        if pid == r.id:
            return False
        now = clock.now()
        window = self._dead_window()
        boot = getattr(r, "_boot_mono", 0.0)
        seen = getattr(r, "peer_seen", None)
        if not seen:
            return False
        if now - seen.get(pid, boot) < window:
            return False  # heard from it recently: alive
        loud = sum(
            1 for p in r.cfg.replica_ids
            if p not in (r.id, pid) and now - seen.get(p, boot) < window
        )
        return loud >= max(1, r.cfg.weak_quorum - 1)

    def next_live_target(self, start: int) -> int:
        """First view at/after `start` whose primary is not evidence-
        dead, skipping at most one committee rotation (n-1 views) so a
        totally-dark evidence table can never stall escalation. Each
        skip saves the full retransmit-then-escalate ladder rung —
        +369..+750 s of measured tail in the search-found repro, where every
        live replica camped on the crashed primary's target view."""
        v = start
        for _ in range(self.r.cfg.n - 1):
            if not self.primary_evidence_dead(v):
                return v
            self.r.metrics["deadview_skipped"] += 1
            v += 1
        return v

    def _backlog_head(self):
        """Oldest outstanding client work, as a stable identity: relay
        and pending buffers are insertion-ordered, so their first keys
        are the longest-waiting requests."""
        r = self.r
        k = next(iter(r.relay_buffer), None)
        if k is not None:
            return ("relay", k)
        if r.pending_requests:
            req = r.pending_requests[0]
            return ("pend", (req.client_id, req.timestamp))
        return None

    # -- view sync ------------------------------------------------------

    MAX_HINT_FETCHES = 8  # unanswered NewViewFetch rounds per hint

    def note_higher_view(self, v: int) -> None:
        """Signature-verified traffic from view v > ours: remember it as
        evidence a NEW-VIEW exists that we never received (the probe
        fetches it — replica.send_slot_probe). Starts the probe chain:
        a quiescent replica (no outstanding work, no parked blocks) that
        lost the one NEW-VIEW frame would otherwise never fetch it."""
        if self.r.view < v <= self.r.view + self.MAX_VIEWS_AHEAD:
            if v > self._view_hint:
                self._view_hint = v
                self._hint_fetches = 0
            self.ensure_probe()

    def pending_view_hint(self) -> int:
        """The view to fetch a NEW-VIEW for, or 0. Expires after
        MAX_HINT_FETCHES unanswered rounds: a single forged higher-view
        message from a faulty replica must not fuel fetch traffic
        forever (a genuine NEW-VIEW answers within a round or two; fresh
        evidence re-arms the counter via note_higher_view)."""
        if self._view_hint <= self.r.view:
            self._view_hint = 0
            return 0
        if self._hint_fetches >= self.MAX_HINT_FETCHES:
            self._view_hint = 0
            return 0
        return self._view_hint

    def count_hint_fetch(self) -> None:
        """A NewViewFetch for the current hint actually went out."""
        self._hint_fetches += 1

    # -- initiating -----------------------------------------------------

    async def start_view_change(self, new_view: int) -> None:
        """Stop participating in the current view, broadcast VIEW-CHANGE."""
        if new_view <= self.target_view and self.in_view_change:
            return
        if new_view <= self.r.view:
            return
        self.in_view_change = True
        self.target_view = new_view
        self._target_expiries = 0
        self._last_target_support = -1
        self.r.metrics["view_changes_started"] += 1
        # exponential backoff: if this view change stalls, suspect further
        self._timeout = min(self._timeout * 2, 60.0)
        if self.r.cfg.view_timeout > 0:
            loop = asyncio.get_running_loop()
            self.cancel()
            self._timer = loop.call_later(self._jitter(self._timeout), self._expired)
            # the recovery probe keeps running while frozen (see _probe:
            # catch-up in the current view is a frozen replica's only way
            # back when the committee never joins its view change)
            self._probe_timer = loop.call_later(
                self._jitter(max(0.5, self._timeout / 4)), self._probe
            )

        await self.r.ensure_checkpoint_qc()  # QC mode: one aggregate for h
        vc = self.build_view_change(new_view)
        self.r.signer.sign_msg(vc)
        # trace envelope: view-change traffic carries no slot — seq=-1
        # keeps the edge out of slot DAG joins but in the Perfetto view
        wire = trace.stamp(
            vc.to_wire(), trace.VIEWCHANGE, new_view, -1, self.r.id
        )
        # Size guard: prepared proofs embed whole request blocks, so a full
        # window of full batches can exceed the certificate wire cap — the
        # message would be undeliverable exactly when a loaded primary
        # fails. Surface it loudly; the roadmap fix is digest-only P-set
        # entries with on-demand block fetch.
        if len(wire) > ViewChange.MAX_WIRE_BYTES:
            self.r.metrics["viewchange_oversized"] += 1
            log.error(
                "%s: VIEW-CHANGE(%d) exceeds wire cap (%d proofs); "
                "reduce max_batch/watermark_window",
                self.r.id, new_view, len(vc.prepared_proofs),
            )
        # certificate-size observability: the qc_mode-vs-plain storm
        # comparison hinges on these (a QC VIEW-CHANGE is O(1), a plain
        # one embeds full request blocks per prepared seq)
        self.r.metrics["max_viewchange_bytes"] = max(
            self.r.metrics.get("max_viewchange_bytes", 0), len(wire)
        )
        await self.r.transport.broadcast(wire, self.r.cfg.replica_ids)
        await self.on_view_change(vc)  # count our own

    async def resend_view_change(self) -> None:
        """Rebuild and rebroadcast our VIEW-CHANGE for the CURRENT target
        (timer expiry while frozen — see _expired). The prepared state is
        frozen so the P-set is unchanged; the checkpoint proof may be
        fresher, which only helps the new primary."""
        if not self.in_view_change:
            return
        await self.r.ensure_checkpoint_qc()
        vc = self.build_view_change(self.target_view)
        self.r.signer.sign_msg(vc)
        wire = trace.stamp(
            vc.to_wire(), trace.VIEWCHANGE, self.target_view, -1, self.r.id
        )
        await self.r.transport.broadcast(wire, self.r.cfg.replica_ids)

    def build_view_change(self, new_view: int) -> ViewChange:
        r = self.r
        cp_proof = []
        if r.stable_seq > 0:
            qc = r.checkpoint_qcs.get(r.stable_seq)
            if qc is not None:
                # QC mode: ONE aggregate proves h (vs 2f+1 signed msgs)
                cp_proof = [qc.to_dict()]
            else:
                # ship only votes for the digest that actually stabilized:
                # one Byzantine checkpoint with a divergent digest in the
                # stored map would otherwise make validate_view_change
                # (len(digests) != 1) reject the whole VIEW-CHANGE
                votes = r.checkpoints.get(r.stable_seq, {})
                counts: Dict[str, int] = {}
                for cp in votes.values():
                    counts[cp.state_digest] = counts.get(cp.state_digest, 0) + 1
                stable_digest = max(counts, key=counts.get, default=None)
                cp_proof = [
                    cp.to_dict()
                    for cp in votes.values()
                    if cp.state_digest == stable_digest
                ][: r.cfg.n]
        # Castro-Liskov P-set: ONE certificate per seq — the highest-view
        # one. A seq prepared in two successive views (prepared in v,
        # re-prepared via the O-set in v+1, not committed) must not emit
        # duplicate-seq proofs: validate_view_change rejects those, which
        # would silence this replica in every future failover.
        best: Dict[int, Tuple[int, Dict[str, Any]]] = {}
        for (view, seq), inst in sorted(r.instances.items()):
            if seq <= r.stable_seq or view >= new_view:
                continue
            proof = inst.prepared_proof()
            if proof is not None:
                cur = best.get(seq)
                if cur is None or view > cur[0]:
                    best[seq] = (view, proof)
        proofs = [best[seq][1] for seq in sorted(best)]
        return ViewChange(
            new_view=new_view,
            stable_seq=r.stable_seq,
            checkpoint_proof=cp_proof,
            prepared_proofs=proofs,
        )

    async def _verify_qcs(self, qcs) -> bool:
        """Pairing-check the quorum certs embedded in a certificate in
        ONE worker-thread dispatch (a per-cert to_thread round-trip costs
        an event-loop hop each — a NEW-VIEW carries up to 2f+1 certs and
        failover is latency-critical). Inside the thread the certs ride
        ONE RLC multi-pairing (qc.verify_qcs_all — 2 Miller loops per
        distinct signer set instead of 2 per cert), which preserves the
        old sequential path's DoS bound: a Byzantine certificate stuffed
        with fabricated aggregates costs one batch check and is rejected
        whole. Honest certificates' QCs are memoized process-wide
        (consensus/qc.py) so re-validation is free."""
        if not qcs:
            return True
        cfg = self.r.cfg
        return await clock.off_thread(qc_mod.verify_qcs_all, cfg, list(qcs))

    # -- receiving ------------------------------------------------------

    async def on_view_change(self, msg: ViewChange) -> None:
        """Signature-verified VIEW-CHANGE arrives (own or peer's)."""
        r = self.r
        r.metrics["vc_msgs_seen"] += 1
        if msg.new_view <= r.view:
            r.metrics["vc_msgs_stale"] += 1
            return
        if msg.new_view > r.view + self.MAX_VIEWS_AHEAD:
            r.metrics["viewchange_too_far"] += 1
            return
        # Full nested-certificate validation only where it is consumed:
        # at the TARGET VIEW'S PRIMARY, whose O-set the proofs feed
        # (normally pre-validated by the verify sweep; computed here for
        # our own VC). Backups count the envelope-verified sender toward
        # the join rule / primary quorum and validate the proofs inside
        # the NEW-VIEW instead — full validation at all n replicas was an
        # n^2 certificate walk that dominated storm-round CPU.
        res = getattr(msg, "_validated", None)
        if res is None and r.cfg.primary(msg.new_view) == r.id:
            res = validate_view_change(r.cfg, msg, current_view_floor=r.view)
            if res is None:
                r.metrics["bad_viewchange"] += 1
                return
        if res is not None:
            if not await self._verify_qcs(res[3]):
                r.metrics["bad_viewchange_qc"] += 1
                if r.auditor is not None:
                    # the envelope was signature-verified; a certificate
                    # carrying unpairable aggregates is audit evidence
                    r.auditor.observe_bad_certificate_qc(
                        msg, "viewchange_bad_qc"
                    )
                return
        store = self.vc_store.setdefault(msg.new_view, {})
        # Backups keep only the SENDER (join counting) — retaining the
        # unvalidated body would let one Byzantine replica park
        # MAX_VIEWS_AHEAD x 64 MiB of junk prepared_proofs per backup.
        # The target view's primary keeps the full (validated) message:
        # its NEW-VIEW is assembled from exactly these.
        store[msg.sender] = msg if res is not None else None
        # The 2f+1th VIEW-CHANGE for our target just landed: only NOW can
        # the new primary even begin building its NEW-VIEW, so grant it a
        # fresh (backed-off) window. Without this the clock that started
        # at our own timer expiry keeps running through the whole
        # collect-certify-install pipeline, and at sizes where that takes
        # longer than the base timeout every first attempt tears itself
        # down and the committee climbs the backoff ladder (measured:
        # one crash at n=64/QC -> views 1..4 all rejected below-target,
        # p99 = the full 3+6+12+24 s ladder).
        if (
            self.in_view_change
            and msg.new_view == self.target_view
            and len(store) == r.cfg.quorum
        ):
            self._rearm_only()
        if res is not None:
            # adopt the highest checkpoint the certificate proves (state
            # catch-up; backups get the same adoption from the NEW-VIEW's
            # embedded certificates, on_new_view)
            _, cps, _, vqcs = res
            for cp in cps:
                await r.on_checkpoint_msg(cp)
            for cert in vqcs:
                # checkpoint aggregates were pairing-verified above: adopt
                # for our OWN future VIEW-CHANGEs (we may never see the
                # individual checkpoint votes) and stabilize, fetching
                # state from the aggregate's signers
                if cert.phase == "checkpoint":
                    r.checkpoint_qcs.setdefault(cert.seq, cert)
                    await r._stabilize(cert.seq, cert.digest, list(cert.signers))

        # liveness: f+1 replicas moving past us -> join the lowest such view
        if not self.in_view_change or msg.new_view > self.target_view:
            above = [
                v
                for v, senders in self.vc_store.items()
                if v > r.view and len(senders) >= r.cfg.weak_quorum
            ]
            if above:
                lowest = min(above)
                if not (self.in_view_change and self.target_view >= lowest):
                    await self.start_view_change(lowest)

        # new primary: certificate complete -> NEW-VIEW
        if (
            r.cfg.primary(msg.new_view) == r.id
            and len(store) >= r.cfg.quorum
            and msg.new_view not in self.new_view_sent
        ):
            await self._send_new_view(msg.new_view)

    async def _send_new_view(self, new_view: int) -> None:
        r = self.r
        vcs = dict(list(self.vc_store[new_view].items())[: r.cfg.quorum])
        h, o_set = compute_o_set(r.cfg, vcs, new_view)
        pre_prepares = []
        for seq, digest in o_set:
            # detached: the signature covers the digest; every receiver
            # (including this primary, at install) refills the block from
            # its store or fetches it
            pp = PrePrepare(view=new_view, seq=seq, digest=digest, block=[])
            r.signer.sign_msg(pp)
            pre_prepares.append(pp.to_dict())
        # checkpoint certificates repeat across the 2f+1 VCs (they all
        # prove the same h): ship one pooled copy (VERDICT weak #5 — the
        # repeats dominated the 237-419 KB NEW-VIEWs pushed through one
        # core at failover)
        vc_dicts, cp_pool = dedup_checkpoint_proofs(list(vcs.values()))
        nv = NewView(
            new_view=new_view,
            viewchange_proof=vc_dicts,
            pre_prepares=pre_prepares,
            checkpoint_pool=cp_pool,
        )
        r.signer.sign_msg(nv)
        # self-install below must not re-validate the certificate we just
        # assembled from individually-validated VCs (their QCs are
        # pairing-verified and memoized; re-walking 2f+1 nested proofs
        # measured ~2 s of the failover critical path at n=64)
        nv._validated = (vcs, [], [])
        self.new_view_sent.add(new_view)
        r.metrics["new_views_sent"] += 1
        nv_wire = trace.stamp(
            nv.to_wire(), trace.NEWVIEW, new_view, -1, r.id
        )
        r.metrics["max_newview_bytes"] = max(
            r.metrics.get("max_newview_bytes", 0), len(nv_wire)
        )
        if len(nv_wire) > NewView.MAX_WIRE_BYTES:
            # undeliverable: every receiver's from_wire drops it and
            # failover stalls — same guard as the VIEW-CHANGE path
            r.metrics["newview_oversized"] += 1
            log.error(
                "%s: NEW-VIEW(%d) exceeds wire cap (%d B); reduce "
                "max_batch/watermark_window",
                r.id, new_view, len(nv_wire),
            )
        await r.transport.broadcast(nv_wire, r.cfg.replica_ids)
        await self.on_new_view(nv)  # install locally

    async def on_new_view(self, msg: NewView) -> None:
        """Signature-verified NEW-VIEW arrives: validate and install."""
        r = self.r
        if msg.new_view <= r.view:
            return
        if (
            msg.sender == r.cfg.primary(msg.new_view)
            and msg.new_view not in self._nv_granted
        ):
            # the NEW-VIEW for a pending view just arrived (authenticated
            # sender): give its validation+install pipeline one fresh
            # (backed-off) window instead of letting a timer that started
            # at our own expiry tear down an install already in flight.
            # Once per view — a Byzantine primary can't stack grants.
            self._nv_granted = {
                v for v in self._nv_granted if v > r.view
            } | {msg.new_view}
            self._rearm_only()
        if self.in_view_change and msg.new_view < self.target_view:
            # we already promised a later view — our outstanding
            # VIEW-CHANGE freezes prepared state for target_view; rejoining
            # an earlier view could let decisions made there escape a
            # future NEW-VIEW(target) certificate (safety)
            r.metrics["newview_below_target"] += 1
            return
        res = getattr(msg, "_validated", None)
        if res is None:
            res = validate_new_view(r.cfg, msg)
        if res is None:
            r.metrics["bad_newview"] += 1
            if r.auditor is not None:
                # arrived through the verified sweep, so the envelope is
                # good: an invalid NEW-VIEW under the primary's signature
                # is proof-grade evidence (audit I4)
                r.auditor.observe_rejected_new_view(
                    msg, envelope_verified=True
                )
            return
        if not await self._verify_qcs(res[2]):
            r.metrics["bad_newview_qc"] += 1
            if r.auditor is not None:
                r.auditor.observe_bad_certificate_qc(msg, "newview_bad_qc")
            return
        vcs, _, nvqcs = res
        h, o_set = compute_o_set(r.cfg, vcs, msg.new_view)
        # catch up on checkpoints the certificate proves
        for vc in vcs.values():
            for rd in vc.checkpoint_proof:
                cp = _decode(rd, Checkpoint)
                if cp is not None:
                    await r.on_checkpoint_msg(cp)
        for cert in nvqcs:
            # nested checkpoint aggregates (pairing-verified above)
            if cert.phase == "checkpoint":
                r.checkpoint_qcs.setdefault(cert.seq, cert)
                await r._stabilize(cert.seq, cert.digest, list(cert.signers))
        await self.install(msg.new_view, msg)

    async def install(self, new_view: int, nv: NewView) -> None:
        """Adopt the new view and replay its re-issued pre-prepares."""
        r = self.r
        r.view = new_view
        self.in_view_change = False
        self.target_view = new_view
        self._target_expiries = 0
        self._last_target_support = -1
        self.vc_store = {v: s for v, s in self.vc_store.items() if v > new_view}
        # same for the resend-validation memo: entries for installed
        # views pin fully-parsed certificates (whole request blocks in
        # non-QC mode) and would otherwise live until 128 future inserts
        # that a replica who is primary only every n-th view may never see
        r._vc_validation_cache = {
            k: v for k, v in r._vc_validation_cache.items() if k[1] > new_view
        }
        # NOTE: the backoff timeout is deliberately NOT reset here — only
        # actual request progress resets it (reset() via _execute_ready).
        # Resetting on install lets a slow-but-correct view (e.g. QC
        # pairing latency > base timeout) be torn down forever: install,
        # re-arm at base, expire before the first commit, repeat — a
        # self-inflicted view-change storm; keeping the attempt-doubling
        # ladder (start_view_change) un-reset preserves escalation for
        # chronically slow views. The post-install window does get a
        # FLOOR of 3x base: install is real progress, but the round
        # isn't safe until the first commit, and the post-install
        # pipeline (relay adoption, re-proposals, a full QC round
        # through congested queues) routinely outlives the base window —
        # early installers expiring just before the first commit tore
        # down healthy views (measured at n=64: install t+0.1, expiry
        # t+6.0, first commit t+6.5). A floor (not a doubling: that
        # compounded into 48 s windows across back-to-back crashes)
        # bounds consecutive-crash recovery while still covering the
        # pipeline.
        base = r.cfg.view_timeout
        self._timeout = min(max(self._timeout, 3 * base), 60.0)
        self._rearm_only()
        r.metrics["views_installed"] += 1
        # retain the certificate: peers that lost the one NEW-VIEW
        # broadcast re-fetch it from us (messages.NewViewFetch)
        r.last_new_view = nv
        # old views' QC-sender mute counters are moot once the view moves;
        # on_qc only records failures for the CURRENT view, so every key
        # is from a view < new_view — clear the lot
        r._qc_bad_by_sender.clear()
        # likewise block fetches buffered under dead views: this install
        # re-buffers what its own O-set still needs; stale entries would
        # hold has_outstanding_work() true forever
        r.prune_stale_block_pending(new_view)

        decoded_pps: List[PrePrepare] = []
        for rd in nv.pre_prepares:
            pp = _decode(rd, PrePrepare)
            if pp is not None:  # validated already; defensive
                decoded_pps.append(pp)
        spec = getattr(r, "spec", None)
        if spec is not None:
            # speculative-divergence detection: the O-set is
            # the certified truth for every in-window slot — any
            # speculated seq whose digest loses (replaced, or no-op
            # filled, or beyond the O-set horizon) walks the speculated
            # suffix back to the committed anchor BEFORE the re-issues
            # replay and re-prepare
            spec.on_new_view_install(
                [(pp.seq, pp.digest) for pp in decoded_pps]
            )
        max_seq = r.stable_seq
        missing: List[str] = []
        for pp in decoded_pps:
            max_seq = max(max_seq, pp.seq)
            # resolve the detached block: no-op digests fill trivially,
            # known digests fill from the store, unknown ones go through
            # the fetch protocol (replica delivers on BlockReply)
            filled = r.resolve_block(pp)
            if filled is None:
                missing.append(pp.digest)
                r.buffer_for_block(pp)
                continue
            if filled.seq > r.stable_seq + r.cfg.watermark_window:
                # local watermark lags the certificate's h (state transfer
                # pending): _on_phase would silently drop this seq and we'd
                # never participate in the slot. Buffer; the replica
                # replays once _advance_stable catches up.
                r.vc_replay[filled.seq] = filled
            else:
                await r.on_phase_msg(filled)
        if missing:
            await r.request_blocks(missing)
        if r.cfg.primary(new_view) == r.id:
            r.next_seq = max_seq + 1
            r.adopt_relayed_requests()
        else:
            # stranded client work (a deposed primary's backlog, relays
            # aimed at dead primaries) must chase the NEW primary — the
            # O-set only re-issues PREPARED work, so anything less
            # travelled relies on exactly this hand-off
            await r.rerelay_outstanding(new_view)
        # the new view's pre-prepares and votes that reached us before
        # this install
        await r.replay_ahead()
        await r.propose_if_ready()
