"""Consensus audit plane: online safety-invariant monitor + evidence ledger.

The metrics plane (telemetry.py) says how FAST the
committee is moving and the span plane (spans.py) says WHERE the time
goes — but nothing watches WHAT the protocol agreed on. A replica that
equivocates, a fork at one (view, seq), or silent checkpoint divergence
passes every counter and span check. This module is the accountability
layer:

- ``SafetyAuditor``: a per-replica online monitor tapping the
  already-signature-verified message stream (replica._finish_sweep and
  friends) and continuously checking the safety invariants:

  I1 **equivocation** — no two verified quorum-critical messages from
     the same replica with the same (view, seq, phase) but different
     digests (pre-prepare / prepare / commit);
  I2 **checkpoint consistency** — one state digest per (replica, seq),
     and every peer's checkpoint digest at a seq where we hold our own
     must match ours (checkpoint digests are a deterministic function
     of the agreed history — replica._checkpoint_snapshot);
  I3 **commit uniqueness** — no two committed digests at one seq
     (locally executed blocks and verified commit QCs feed one store);
  I4 **certificate honesty** — verified prepare/commit QCs at one
     (view, seq, phase) agree on the digest (conflicting aggregates
     prove their overlapping >= f+1 signers double-voted), and a
     NEW-VIEW whose certificate fails validation or whose embedded
     aggregates fail their pairing is itself evidence against the
     primary that signed it.

- Every violation becomes a tamper-evident **evidence record**: the
  conflicting signed messages VERBATIM (pre-prepares block-detached —
  their signatures cover the detached payload, messages.PrePrepare), so
  any third party can re-verify the culprit signatures with nothing but
  the committee's public keys, hash-chained (``prev``/``h``) and
  appended line-flushed to ``<log_dir>/<id>.evidence.jsonl``.

- A compact **observation ledger** (``<log_dir>/<id>.audit.jsonl``)
  records what this node accepted per slot — one line per admitted
  proposal (the SIGNED detached pre-prepare), per own checkpoint, per
  executed block — so ``tools/ledger_audit.py`` can join nodes' ledgers
  into a cross-node divergence report. This is what catches the
  disjoint-recipient-halves equivocator no single node ever sees both
  halves of (faults.EquivocatingPrimary).

The auditor is wired like the tracer: ``replica.auditor`` is None by
default and every hook is a cheap attribute check; attach via
``LocalCommittee.attach_auditors``, ``node.py --audit``, or
``bench_consensus.py --flight-dir``. A violation triggers the same
forensic dump path as a stall (``ProgressWatchdog.dump``) when a
watchdog is attached. Schema + triage walkthrough: docs/AUDIT.md.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from .messages import (
    Checkpoint,
    Commit,
    Message,
    NewView,
    PrePrepare,
    Prepare,
    QuorumCert,
    canonical_json,
    sha256_hex,
)
from .telemetry import SCHEMA_VERSION, _JsonlSink

log = logging.getLogger("pbft.audit")

#: chain anchor: the ``prev`` of a ledger's first evidence record
GENESIS = "0" * 64

#: attribution classes. PROOF: the record alone convicts the accused
#: (e.g. two conflicting messages under one signature). DIVERGENCE: the
#: record documents inconsistency whose blame needs corroboration —
#: ledger_audit confirms it against the cross-node majority.
PROOF = "proof"
DIVERGENCE = "divergence"


# ---------------------------------------------------------------------------
# tamper-evident evidence chain + third-party re-verification
# ---------------------------------------------------------------------------


def chain_hash(rec: Dict[str, Any]) -> str:
    """Hash of one evidence record (its own ``h`` excluded; ``prev`` —
    the previous record's hash — included, so the records form a chain:
    editing or dropping any line breaks every later hash)."""
    return sha256_hex(
        canonical_json({k: v for k, v in rec.items() if k != "h"})
    )


def parse_evidence(lines) -> Tuple[List[Dict[str, Any]], Optional[str]]:
    """Parse + chain-verify one node's evidence ledger. Returns
    (records, error) — error is a human-readable reason and means the
    ledger must be REJECTED (tampered, truncated, or corrupt), the
    ledger_audit nonzero-exit contract."""
    recs: List[Dict[str, Any]] = []
    prev = GENESIS
    for i, ln in enumerate(lines):
        ln = ln.strip()
        if not ln:
            continue
        try:
            rec = json.loads(ln)
        except ValueError:
            return recs, f"line {i + 1}: undecodable JSON"
        if not isinstance(rec, dict) or "h" not in rec or "prev" not in rec:
            return recs, f"line {i + 1}: not an evidence record"
        if chain_hash(rec) != rec["h"]:
            return recs, f"line {i + 1}: hash mismatch (record tampered)"
        if rec["prev"] != prev:
            return recs, f"line {i + 1}: broken chain link (record dropped?)"
        prev = rec["h"]
        recs.append(rec)
    return recs, None


def verify_signed_dicts(cfg, dicts, verifier=None) -> bool:
    """Re-verify a list of wire-message dicts against the committee's
    published keys: Ed25519 envelopes ride ONE ``verify_batch`` call
    (the same batch-verifier seam consensus uses — crypto/verifier.py),
    BLS aggregates go through the QC pairing check (consensus/qc.py).
    This is the third-party check evidence records exist for."""
    from .crypto.verifier import BatchItem, best_cpu_verifier

    items: List[BatchItem] = []
    for d in dicts:
        try:
            msg = Message.from_dict(d)
        except ValueError:
            return False
        if isinstance(msg, QuorumCert):
            from .consensus import qc as qc_mod

            if not qc_mod.verify_qc(cfg, msg):
                return False
            continue
        pub = cfg.pubkey(msg.sender)
        if pub is None or not msg.sig:
            return False
        try:
            sig = bytes.fromhex(msg.sig)
        except ValueError:
            return False
        items.append(
            BatchItem(pubkey=pub, msg=msg.signing_payload(), sig=sig)
        )
    if not items:
        return True
    v = verifier if verifier is not None else best_cpu_verifier()
    return all(v.verify_batch(items))


def reverify_record(cfg, rec: Dict[str, Any], verifier=None) -> bool:
    """Do the signed messages inside one evidence record re-verify?"""
    msgs = rec.get("msgs")
    if not isinstance(msgs, list):
        return False
    return verify_signed_dicts(cfg, msgs, verifier)


def substantiate_record(cfg, rec: Dict[str, Any]) -> bool:
    """Do the attached messages actually CONSTITUTE the claimed
    violation against the claimed accused? Evidence ledgers are
    self-authored: signature re-verification alone would let a
    byzantine node chain valid-but-irrelevant signed messages (or an
    empty msgs list) under a proof-grade kind and frame an honest
    replica. Content binding closes that — ledger_audit accuses only on
    records that are both signature-valid AND self-substantiating."""
    kind = rec.get("kind")
    accused = [str(a) for a in (rec.get("accused") or [])]
    msgs: List[Message] = []
    for d in rec.get("msgs") or []:
        try:
            msgs.append(Message.from_dict(d))
        except ValueError:
            return False
    if kind == "equivocation":
        # >= 2 messages, one sender (the accused), one (type, view,
        # seq), >= 2 digests. The type is part of the slot identity: a
        # prepare for X plus a commit for Y is not equivocation.
        if len(msgs) < 2 or len(accused) != 1:
            return False
        if {m.sender for m in msgs} != {accused[0]}:
            return False
        if not all(isinstance(m, (PrePrepare, Prepare, Commit))
                   for m in msgs):
            return False
        if len({(type(m), m.view, m.seq) for m in msgs}) != 1:
            return False
        return len({m.digest for m in msgs}) >= 2
    if kind == "checkpoint_equivocation":
        if len(msgs) < 2 or len(accused) != 1:
            return False
        if not all(isinstance(m, Checkpoint) for m in msgs):
            return False
        if {m.sender for m in msgs} != {accused[0]}:
            return False
        if len({m.seq for m in msgs}) != 1:
            return False
        return len({m.state_digest for m in msgs}) >= 2
    if kind == "checkpoint_divergence":
        # two checkpoints, one seq, two digests, one signed by the
        # accused (the other is the reporter's counter-signature)
        if len(msgs) != 2 or len(accused) != 1:
            return False
        if not all(isinstance(m, Checkpoint) for m in msgs):
            return False
        if len({m.seq for m in msgs}) != 1:
            return False
        if len({m.state_digest for m in msgs}) != 2:
            return False
        return accused[0] in {m.sender for m in msgs}
    if kind == "qc_equivocation":
        if len(msgs) < 2 or not accused:
            return False
        if not all(isinstance(m, QuorumCert) for m in msgs):
            return False
        if len({(m.view, m.seq, m.phase) for m in msgs}) != 1:
            return False
        if len({m.digest for m in msgs}) < 2:
            return False
        overlap = set(msgs[0].signers)
        for m in msgs[1:]:
            overlap &= set(m.signers)
        return set(accused) <= overlap
    if kind == "newview_invalid":
        # one NEW-VIEW, signed by the accused, that the deterministic
        # validator really does reject. Deliberately NOT limited to the
        # view's primary: a backup signing any NEW-VIEW is misbehaving
        # (validate_new_view rejects wrong-primary senders, and the
        # online monitor records exactly that), so requiring
        # sender == primary here would misclassify an honest reporter's
        # record as a framing attempt.
        if len(msgs) != 1 or not isinstance(msgs[0], NewView):
            return False
        nv = msgs[0]
        if accused != [nv.sender]:
            return False
        from .consensus.viewchange import validate_new_view

        return validate_new_view(cfg, nv) is None
    # divergence-attribution kinds that never reach the accusation path
    # on their own content (commit_fork is unattributed; bad-qc kinds
    # need the pairing re-run ledger_audit does not perform)
    return kind in ("commit_fork", "newview_bad_qc", "viewchange_bad_qc")


class _LazySink:
    """Evidence sink that creates its file only on the FIRST violation:
    an honest run leaves NO evidence file at all (the clean-bill signal
    pbft_top's post-mortem fallback and ledger_audit key off), and the
    tamper-evident chain never needs an empty-file special case."""

    def __init__(self, path: Optional[str], max_bytes: int) -> None:
        self.path = path
        self.max_bytes = max_bytes
        self._sink: Optional[_JsonlSink] = None

    def write(self, doc: Dict[str, Any]) -> None:
        if self.path is None:
            return
        if self._sink is None:
            self._sink = _JsonlSink(self.path, max_bytes=self.max_bytes)
        self._sink.write(doc)

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None


# ---------------------------------------------------------------------------
# the online monitor
# ---------------------------------------------------------------------------


class SafetyAuditor:
    """One replica's online safety monitor (see module docstring).

    Single-threaded by design: every hook runs on the replica's event
    loop, so the stores need no locks. Every hook is exception-proof —
    an auditor bug must never take down the consensus it observes
    (failures count in ``check_errors`` and log once)."""

    MAX_VOTES = 16384  # (sender, view, seq, phase) first-sighting store
    MAX_QCS = 4096  # (view, seq, phase) verified-aggregate store
    MAX_CKPT_SEQS = 128  # checkpoint seqs tracked concurrently
    MAX_COMMITS = 8192  # executed/certified seq -> digest store
    MAX_REPORTED = 4096  # violation dedup keys

    #: evidence is precious and violations are rare: rotate only at a
    #: bound no honest-adjacent run approaches, so the hash chain stays
    #: unbroken in practice (rotation would orphan the chain head)
    EVIDENCE_MAX_BYTES = 256 * 1024 * 1024

    #: lifetime cap on synchronous envelope re-checks for rejected
    #: NEW-VIEWs (each costs a canonical_json of a possibly-multi-MB
    #: message plus an Ed25519 verify ON THE EVENT LOOP): without the
    #: bound, spamming structurally-invalid NEW-VIEWs with garbage
    #: signatures would make the auditor itself the DoS amplifier.
    #: Honest runs reject approximately zero NEW-VIEWs, and a handful of
    #: proof-grade records is as damning as a thousand.
    MAX_ENVELOPE_CHECKS = 64

    def __init__(
        self,
        node_id: str,
        cfg,
        log_dir: Optional[str] = None,
        watchdog=None,
        ring: int = 256,
    ) -> None:
        self.node_id = node_id
        self.cfg = cfg
        self.watchdog = watchdog
        self.violations = 0
        self.observations = 0
        self.check_errors = 0
        self.by_kind: Dict[str, int] = {}
        self.last_kind: Optional[str] = None
        self.last_accused: List[str] = []
        self.accused_ever: set = set()
        self.evidence_path = (
            os.path.join(log_dir, f"{node_id}.evidence.jsonl")
            if log_dir
            else None
        )
        self._evidence = _LazySink(self.evidence_path, self.EVIDENCE_MAX_BYTES)
        self._obs = (
            _JsonlSink(os.path.join(log_dir, f"{node_id}.audit.jsonl"))
            if log_dir
            else None
        )
        self._ring: deque = deque(maxlen=ring)
        self._prev_hash = GENESIS
        # first-sighting stores, all bounded + GC'd at the watermark
        self._votes: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._qcs: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._ckpts: "OrderedDict[int, Dict[str, tuple]]" = OrderedDict()
        self._commits: "OrderedDict[int, tuple]" = OrderedDict()
        self._reported: "OrderedDict[tuple, None]" = OrderedDict()
        self._autopsy_fired = False
        self._err_logged = False
        self._cpu_verifier = None  # lazy: rejected-NEW-VIEW envelope check
        self._envelope_checks = 0  # spent against MAX_ENVELOPE_CHECKS

    # -- wiring ----------------------------------------------------------

    def attach_watchdog(self, watchdog) -> None:
        """A safety violation triggers the same forensic dump path as a
        stall: one autopsy per auditor (violations often cascade — the
        first one captures the interesting state)."""
        self.watchdog = watchdog

    def on_epoch(self, new_cfg) -> None:
        """The committee reconfigured (replica._activate_epoch):
        adopt the new membership for key lookups/envelope re-checks and
        leave an epoch marker in the observation ledger so cross-node
        joins can segment history by epoch. The invariant stores (votes,
        checkpoints, commits) deliberately carry over — I1-I4 must hold
        ACROSS the boundary: a replica that signed conflicting digests
        straddling an epoch switch is still equivocating. ledger_audit
        ignores unknown evt kinds by design, so the marker is additive."""
        self.cfg = new_cfg
        self._observe({
            "evt": "epoch",
            "epoch": getattr(new_cfg, "epoch", 0),
            "replica_ids": list(new_cfg.replica_ids),
        })

    def close(self) -> None:
        self._evidence.close()
        if self._obs is not None:
            self._obs.close()
            self._obs = None

    # -- hook entry points (all exception-proof) -------------------------

    def observe_message(self, msg) -> None:
        """A signature-verified message accepted by the sweep. Called
        for every accepted message; non-quorum-critical kinds fall
        through the isinstance ladder at one check each."""
        try:
            if isinstance(msg, PrePrepare):
                self._on_proposal(msg.sender, msg.view, msg.seq, msg.digest,
                                  self._detached(msg))
            elif isinstance(msg, (Prepare, Commit)):
                if msg.digest:
                    self._on_vote(msg)
            elif isinstance(msg, Checkpoint):
                self._on_checkpoint(msg)
            elif isinstance(msg, NewView):
                self._on_new_view(msg)
        except Exception:
            self._check_failed()

    def observe_qc(self, qc: QuorumCert) -> None:
        """A PAIRING-VERIFIED quorum certificate (replica._on_qc, after
        the aggregate check — an unverified aggregate naming honest
        signers must never become evidence against them)."""
        try:
            d = qc.to_dict()
            key = (qc.view, qc.seq, qc.phase)
            cur = self._qcs.get(key)
            if cur is None:
                self._qcs[key] = (qc.digest, d, frozenset(qc.signers))
                while len(self._qcs) > self.MAX_QCS:
                    self._qcs.popitem(last=False)
            elif cur[0] != qc.digest:
                overlap = sorted(cur[2] & set(qc.signers))
                self._report(
                    "qc_equivocation", overlap, [cur[1], d],
                    attribution=PROOF,
                    dedup=("qce", key, tuple(sorted((cur[0], qc.digest)))),
                    view=qc.view, seq=qc.seq, phase=qc.phase,
                    detail=f"conflicting verified {qc.phase} aggregates at "
                    f"(view {qc.view}, seq {qc.seq}): the {len(overlap)} "
                    "overlapping signers signed both digests",
                )
            if qc.phase == "commit":
                self._on_committed(qc.view, qc.seq, qc.digest, d)
        except Exception:
            self._check_failed()

    def observe_commit(self, view: int, seq: int, digest: str) -> None:
        """A block this replica applied in order (replica._execute_ready)
        — one observation-ledger line per seq, the raw material of the
        cross-node digest agreement matrix."""
        try:
            self._observe({
                "evt": "commit", "view": view, "seq": seq, "digest": digest,
            })
            self._on_committed(view, seq, digest, None)
        except Exception:
            self._check_failed()

    def observe_rejected_new_view(self, msg: NewView,
                                  envelope_verified: bool = False) -> None:
        """A NEW-VIEW that failed structural/coverage validation
        (viewchange.validate_new_view): a certificate whose re-issued
        O-set does not match the deterministic function of its embedded
        VIEW-CHANGEs is a lying primary. On the precheck path the
        envelope signature has NOT been batch-verified yet, so the
        auditor re-checks it here before recording — a forged envelope
        must not frame the named primary."""
        try:
            if not isinstance(msg, NewView):
                return
            dk = ("nv-invalid", msg.sender, msg.new_view)
            if dk in self._reported:
                return
            if not envelope_verified:
                # bounded: the check is loop-synchronous and its cost
                # scales with the (attacker-chosen) message size
                if self._envelope_checks >= self.MAX_ENVELOPE_CHECKS:
                    return
                self._envelope_checks += 1
                if not self._envelope_ok(msg):
                    return  # unattributable: drop, like the runtime does
            self._report(
                "newview_invalid", [msg.sender], [msg.to_dict()],
                attribution=PROOF, dedup=dk, view=msg.new_view,
                detail="NEW-VIEW failed validation (wrong-primary sender, "
                "O-set not covering the claimed prepared set, or malformed "
                "proofs) under the sender's valid signature",
            )
        except Exception:
            self._check_failed()

    def observe_bad_certificate_qc(self, msg, kind: str) -> None:
        """A view-change-class certificate whose embedded BLS aggregates
        failed their pairing check (viewchange._verify_qcs). The
        envelope was already signature-verified; attribution stays
        DIVERGENCE because a local bls-key configuration gap is
        indistinguishable from fabrication without re-running the
        pairing elsewhere (ledger_audit does exactly that)."""
        try:
            dk = (kind, msg.sender, getattr(msg, "new_view", 0))
            self._report(
                kind, [msg.sender], [msg.to_dict()],
                attribution=DIVERGENCE, dedup=dk,
                view=getattr(msg, "new_view", 0),
                detail="certificate's embedded BLS aggregate failed its "
                "pairing check",
            )
        except Exception:
            self._check_failed()

    def gc(self, stable_seq: int) -> None:
        """Fold the stores at the stable watermark, mirroring the
        replica's own GC (replica._advance_stable): everything at/below
        h is covered by a 2f+1 checkpoint certificate."""
        try:
            self._votes = OrderedDict(
                (k, v) for k, v in self._votes.items() if k[2] > stable_seq
            )
            self._qcs = OrderedDict(
                (k, v) for k, v in self._qcs.items() if k[1] > stable_seq
            )
            self._ckpts = OrderedDict(
                (s, m) for s, m in self._ckpts.items() if s >= stable_seq
            )
            self._commits = OrderedDict(
                (s, v) for s, v in self._commits.items() if s > stable_seq
            )
        except Exception:
            self._check_failed()

    # -- surfaces --------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``audit`` block of NodeTelemetry.snapshot()."""
        return {
            "violations": self.violations,
            "observations": self.observations,
            "by_kind": dict(sorted(self.by_kind.items())),
            "last_kind": self.last_kind,
            "last_accused": ",".join(self.last_accused) or None,
            "check_errors": self.check_errors,
            "chain_head": self._prev_hash,
            "evidence_path": self.evidence_path,
        }

    def recent(self) -> List[Dict[str, Any]]:
        return list(self._ring)

    # -- invariant checks ------------------------------------------------

    @staticmethod
    def _detached(pp: PrePrepare) -> Dict[str, Any]:
        """Evidence form of a pre-prepare: block detached (the signature
        covers the detached payload, so the record re-verifies without
        shipping the block — same move as the view-change P-set)."""
        d = pp.to_dict()
        d["block"] = []
        return d

    def _on_proposal(self, sender, view, seq, digest, d,
                     record_observation: bool = True) -> None:
        key = (sender, view, seq, "preprepare")
        cur = self._votes.get(key)
        if cur is None:
            self._votes[key] = (digest, d)
            while len(self._votes) > self.MAX_VOTES:
                self._votes.popitem(last=False)
            if record_observation:
                self._observe({
                    "evt": "proposal", "view": view, "seq": seq,
                    "digest": digest, "sender": sender, "msg": d,
                })
        elif cur[0] != digest:
            self._report(
                "equivocation", [sender], [cur[1], d], attribution=PROOF,
                dedup=("eq", key, tuple(sorted((cur[0], digest)))),
                view=view, seq=seq, phase="preprepare",
                detail=f"{sender} signed two pre-prepares at (view {view}, "
                f"seq {seq}) with different digests",
            )

    def _on_vote(self, msg) -> None:
        phase = msg.KIND  # "prepare" | "commit"
        key = (msg.sender, msg.view, msg.seq, phase)
        cur = self._votes.get(key)
        if cur is None:
            self._votes[key] = (msg.digest, msg.to_dict())
            while len(self._votes) > self.MAX_VOTES:
                self._votes.popitem(last=False)
        elif cur[0] != msg.digest:
            self._report(
                "equivocation", [msg.sender], [cur[1], msg.to_dict()],
                attribution=PROOF,
                dedup=("eq", key, tuple(sorted((cur[0], msg.digest)))),
                view=msg.view, seq=msg.seq, phase=phase,
                detail=f"{msg.sender} signed two {phase} votes at (view "
                f"{msg.view}, seq {msg.seq}) with different digests",
            )

    def _on_checkpoint(self, msg: Checkpoint) -> None:
        seq = msg.seq
        d = msg.to_dict()
        per = self._ckpts.get(seq)
        if per is None:
            per = self._ckpts[seq] = {}
            while len(self._ckpts) > self.MAX_CKPT_SEQS:
                self._ckpts.popitem(last=False)
        cur = per.get(msg.sender)
        if cur is not None:
            if cur[0] != msg.state_digest:
                self._report(
                    "checkpoint_equivocation", [msg.sender], [cur[1], d],
                    attribution=PROOF,
                    dedup=("cke", msg.sender, seq,
                           tuple(sorted((cur[0], msg.state_digest)))),
                    seq=seq, phase="checkpoint",
                    detail=f"{msg.sender} signed two checkpoints at seq "
                    f"{seq} with different state digests",
                )
            return
        per[msg.sender] = (msg.state_digest, d)
        own = per.get(self.node_id)
        if msg.sender == self.node_id:
            # our own checkpoint: ledger line for the cross-node matrix,
            # then sweep peers that arrived before we executed this far
            self._observe({
                "evt": "checkpoint", "seq": seq,
                "digest": msg.state_digest, "sender": msg.sender, "msg": d,
            })
            for peer, (pdg, pd) in per.items():
                if peer != self.node_id and pdg != msg.state_digest:
                    self._ckpt_divergence(seq, peer, pd, d)
        elif own is not None and own[0] != msg.state_digest:
            self._ckpt_divergence(seq, msg.sender, d, own[1])

    def _ckpt_divergence(self, seq, peer, theirs, ours) -> None:
        """A peer's signed checkpoint digest differs from OUR digest at
        the same seq. Checkpoint digests are a deterministic function of
        the agreed history, so one of the two replicas has diverged —
        which one needs the committee majority (ledger_audit confirms
        against the cross-node matrix), hence DIVERGENCE attribution.
        Both signed checkpoints ship so the accusation re-verifies."""
        self._report(
            "checkpoint_divergence", [peer], [theirs, ours],
            attribution=DIVERGENCE, dedup=("ckd", seq, peer),
            seq=seq, phase="checkpoint",
            detail=f"{peer}'s checkpoint digest at seq {seq} differs from "
            f"{self.node_id}'s",
        )

    def _on_committed(self, view, seq, digest, src) -> None:
        """One store for everything that proves commitment at a seq:
        locally executed blocks and verified commit aggregates. Two
        digests here is the PBFT safety catastrophe (a committed slot
        changed content)."""
        cur = self._commits.get(seq)
        if cur is None:
            self._commits[seq] = (view, digest, src)
            while len(self._commits) > self.MAX_COMMITS:
                self._commits.popitem(last=False)
        elif cur[1] != digest:
            msgs = [m for m in (cur[2], src) if m]
            self._report(
                "commit_fork", [], msgs, attribution=DIVERGENCE,
                dedup=("cf", seq, tuple(sorted((cur[1], digest)))),
                view=view, seq=seq,
                detail=f"two committed digests at seq {seq} "
                f"(views {cur[0]} and {view}) — safety violated",
            )

    def _on_new_view(self, msg: NewView) -> None:
        """An ACCEPTED NEW-VIEW: its re-issued pre-prepares are signed
        proposals by the new primary (fold them into the proposal store
        + ledger — they never transit _finish_sweep individually), and
        the prepared proofs inside its embedded VIEW-CHANGEs carry
        older primaries' signed pre-prepares — the place a
        disjoint-halves fork often first meets a node that admitted the
        other half."""
        for rd in msg.pre_prepares:
            pp = self._decode(rd, PrePrepare)
            if pp is not None:
                self._on_proposal(pp.sender, pp.view, pp.seq, pp.digest,
                                  self._detached(pp))
        validated = getattr(msg, "_validated", None)
        if not validated:
            return
        for vc in validated[0].values():
            proofs = getattr(vc, "prepared_proofs", None) or []
            for proof in proofs:
                if not isinstance(proof, dict):
                    continue
                pp = self._decode(proof.get("pre_prepare"), PrePrepare)
                if pp is not None:
                    # check-only: P-set entries are historical, not this
                    # node's own admission — no ledger line
                    self._on_proposal(
                        pp.sender, pp.view, pp.seq, pp.digest,
                        self._detached(pp), record_observation=False,
                    )

    # -- plumbing --------------------------------------------------------

    @staticmethod
    def _decode(d, want):
        if not isinstance(d, dict):
            return None
        try:
            msg = Message.from_dict(d, _depth_checked=True)
        except ValueError:
            return None
        return msg if isinstance(msg, want) else None

    def _envelope_ok(self, msg) -> bool:
        """Synchronous Ed25519 envelope check for rare, not-yet-verified
        evidence candidates (rejected NEW-VIEWs). Off the quorum hot
        path by construction — validation rejects are exceptional."""
        from .crypto.verifier import BatchItem, best_cpu_verifier

        pub = self.cfg.pubkey(msg.sender)
        if pub is None or not msg.sig:
            return False
        try:
            sig = bytes.fromhex(msg.sig)
        except ValueError:
            return False
        if self._cpu_verifier is None:
            self._cpu_verifier = best_cpu_verifier()
        return bool(self._cpu_verifier.verify_batch(
            [BatchItem(pubkey=pub, msg=msg.signing_payload(), sig=sig)]
        )[0])

    def _observe(self, doc: Dict[str, Any]) -> None:
        self.observations += 1
        if self._obs is not None:
            doc = {
                "schema_version": SCHEMA_VERSION,
                "node": self.node_id,
                "t_wall": round(time.time(), 3),
                **doc,
            }
            self._obs.write(doc)

    def _report(
        self,
        kind: str,
        accused: List[str],
        msgs: List[Dict[str, Any]],
        attribution: str = PROOF,
        dedup: Optional[tuple] = None,
        detail: str = "",
        **fields,
    ) -> None:
        """Record one violation: dedup (resends of the same conflicting
        pair must not spam the ledger), hash-chain, flush, surface."""
        if dedup is not None:
            if dedup in self._reported:
                return
            self._reported[dedup] = None
            while len(self._reported) > self.MAX_REPORTED:
                self._reported.popitem(last=False)
        rec: Dict[str, Any] = {
            "evt": "violation",
            "schema_version": SCHEMA_VERSION,
            "node": self.node_id,
            "t_wall": round(time.time(), 3),
            "kind": kind,
            "accused": list(accused),
            "attribution": attribution,
            "detail": detail,
            "msgs": msgs,
            **fields,
            "prev": self._prev_hash,
        }
        rec["h"] = chain_hash(rec)
        self._prev_hash = rec["h"]
        self.violations += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
        self.last_kind = kind
        self.last_accused = list(accused)
        self.accused_ever.update(accused)
        self._ring.append(rec)
        self._evidence.write(rec)
        log.error(
            "AUDIT %s: %s accusing %s — %s",
            self.node_id, kind, ",".join(accused) or "(unattributed)", detail,
        )
        if self.watchdog is not None and not self._autopsy_fired:
            # a safety violation gets the full stall-forensics treatment
            # (task/thread stacks, instance table, recent spans) — once
            self._autopsy_fired = True
            try:
                self.watchdog.dump(
                    f"safety violation: {kind} accusing "
                    f"{','.join(accused) or '(unattributed)'} — {detail}"
                )
            except Exception:
                log.exception("audit autopsy dump failed")

    def _check_failed(self) -> None:
        self.check_errors += 1
        if not self._err_logged:
            self._err_logged = True
            log.exception("%s: audit check failed (logged once)",
                          self.node_id)
