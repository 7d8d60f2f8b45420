"""Per-(view, seq) PBFT instance state machine — pure logic, no I/O.

Parity target: the reference's ``State`` in pbft/consensus/pbft_impl.go
(Stage enum :27-32, phase methods :55-173, quorum predicates :207-232).
Redesigned:

- One ``Instance`` per (view, seq) so many consensus rounds run
  concurrently (the reference's single scalar ``CurrentState``, node.go:21,
  serializes rounds — its author's gap #2, 需要改进的地方.md:14-15).
- Castro-Liskov quorums: prepared = pre-prepare + 2f+1 distinct prepare
  senders (own vote counts); committed-local = prepared + 2f+1 distinct
  commit senders. (The reference counts 2f votes excluding its own,
  pbft_impl.go:212,227 — same tolerance, different bookkeeping.)
- Inputs are assumed *signature-verified already* (the replica runtime
  batch-verifies via the crypto plane before feeding instances); this
  module still enforces view/seq/digest consistency, mirroring
  ``verifyMsg`` (pbft_impl.go:176-202).

Methods return ``Action`` values describing what the runtime should do
(broadcast a vote, execute a block) — the state machine itself never sends.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

from ..messages import Commit, PrePrepare, Prepare, QuorumCert


class Stage(enum.Enum):
    """Reference: Stage enum pbft_impl.go:27-32 (Idle/PrePrepared/
    Prepared/Committed)."""

    IDLE = 0
    PRE_PREPARED = 1
    PREPARED = 2
    COMMITTED = 3


@dataclass
class SendPrepare:
    view: int
    seq: int
    digest: str


@dataclass
class SendCommit:
    view: int
    seq: int
    digest: str


@dataclass
class ExecuteBlock:
    view: int
    seq: int
    digest: str
    block: List[Dict[str, Any]]


Action = Union[SendPrepare, SendCommit, ExecuteBlock]


@dataclass
class Instance:
    """State of one consensus slot (view, seq) at one replica."""

    view: int
    seq: int
    quorum: int  # 2f+1
    primary: str  # the view's primary — the only allowed pre-prepare sender
    stage: Stage = Stage.IDLE
    digest: Optional[str] = None
    block: Optional[List[Dict[str, Any]]] = None
    pre_prepare: Optional[PrePrepare] = None
    prepares: Dict[str, Prepare] = field(default_factory=dict)
    commits: Dict[str, Commit] = field(default_factory=dict)
    executed: bool = False
    # QC mode (config.qc_mode): transitions are driven by verified
    # QuorumCerts, not by counting votes locally — votes flow to the
    # primary only, so a backup's vote logs never reach quorum.
    qc_mode: bool = False
    prepare_qc: Optional[QuorumCert] = None  # verified, phase=prepare
    commit_qc: Optional[QuorumCert] = None
    t_started: float = 0.0  # perf_counter at pre-prepare admission (stats)
    # phase-transition clocks: set by the runtime when
    # the slot prepares / its commit certificate forms, so the three
    # phase.* spans tile t_started -> execution exactly and their sum
    # reconciles against the commit_ms histogram (tools/critical_path)
    t_prepared: float = 0.0
    t_committed: float = 0.0
    # conflicting-digest rejections retained for forensics:
    # (sender, digest) of messages this slot turned away because they
    # disagreed with the fixed digest — the wedge-autopsy instance table
    # can then tell "slot starved by loss" from "slot contested by a
    # fork" at a glance. Compact tuples, not the messages: a byzantine
    # pre-prepare carries an attacker-sized block, and pinning four of
    # those per contested in-flight slot until watermark GC would be a
    # memory lever. The audit plane (audit.SafetyAuditor) independently
    # records the full signed evidence; this is only the state
    # machine's own breadcrumb.
    conflicts: List[Tuple[str, str]] = field(default_factory=list)
    # incremental counts of votes matching the fixed digest — counting
    # the logs on every arrival was O(n) per vote = O(n^2) per slot per
    # replica (measured ~7% of an n=100 committee's CPU)
    _prep_matching: int = 0
    _com_matching: int = 0

    MAX_CONFLICTS = 4  # forensic breadcrumbs, not a log

    def _note_conflict(self, msg: Union[PrePrepare, Prepare, Commit]) -> None:
        if len(self.conflicts) < self.MAX_CONFLICTS:
            self.conflicts.append((msg.sender, msg.digest))

    def _recount_matching(self) -> None:
        """Digest just became fixed: count the buffered early votes."""
        self._prep_matching = sum(
            1 for v in self.prepares.values() if v.digest == self.digest
        )
        self._com_matching = sum(
            1 for v in self.commits.values() if v.digest == self.digest
        )

    # -- phase inputs -------------------------------------------------------

    def on_pre_prepare(self, msg: PrePrepare) -> List[Action]:
        """Reference: State.PrePrepare (pbft_impl.go:91-109).

        Accept the primary's proposal once; check digest covers the block;
        move to PRE_PREPARED and vote prepare.
        """
        if msg.view != self.view or msg.seq != self.seq:
            return []
        if msg.sender != self.primary:
            return []  # only the view's primary may propose (verifyMsg's
            # primary-identity check; a Byzantine backup must not steal slots)
        if self.pre_prepare is not None:
            if msg.digest != self.digest:
                self._note_conflict(msg)  # contested slot: keep the proof
            return []  # already have one for this slot (first wins)
        if self.digest is not None and msg.digest != self.digest:
            # the slot's digest was already fixed by a verified quorum
            # certificate (QC mode, QC-before-pre-prepare arrival order);
            # an equivocating primary must not swap in a different block
            # and ride the stored commit QC into executing it
            self._note_conflict(msg)
            return []
        if PrePrepare.block_digest(msg.block) != msg.digest:
            return []  # digest mismatch — mirrors verifyMsg digest check
        self.pre_prepare = msg
        if self.digest is None:
            self.digest = msg.digest
            self._recount_matching()
        self.block = msg.block
        if self.stage == Stage.IDLE:
            self.stage = Stage.PRE_PREPARED
        out: List[Action] = [SendPrepare(self.view, self.seq, msg.digest)]
        # Votes that arrived before the pre-prepare (buffered by pools) may
        # already form a quorum — re-evaluate.
        out.extend(self._maybe_advance())
        return out

    def on_prepare(self, msg: Prepare) -> List[Action]:
        """Reference: State.Prepare (pbft_impl.go:115-139)."""
        if msg.view != self.view or msg.seq != self.seq:
            return []
        if self.digest is not None and msg.digest != self.digest:
            self._note_conflict(msg)
            return []  # vote for a different proposal
        if msg.sender in self.prepares:
            return []  # duplicate sender
        self.prepares[msg.sender] = msg
        if self.digest is not None and msg.digest == self.digest:
            self._prep_matching += 1
        return self._maybe_advance()

    def on_commit(self, msg: Commit) -> List[Action]:
        """Reference: State.Commit (pbft_impl.go:145-173)."""
        if msg.view != self.view or msg.seq != self.seq:
            return []
        if self.digest is not None and msg.digest != self.digest:
            self._note_conflict(msg)
            return []
        if msg.sender in self.commits:
            return []
        self.commits[msg.sender] = msg
        if self.digest is not None and msg.digest == self.digest:
            self._com_matching += 1
        return self._maybe_advance()

    # -- quorum predicates --------------------------------------------------

    def prepared(self) -> bool:
        """Reference: prepared() pbft_impl.go:207-217."""
        return (
            self.pre_prepare is not None
            and self._prep_matching >= self.quorum
        )

    def committed(self) -> bool:
        """Reference: committed() pbft_impl.go:222-232."""
        return self.prepared() and self._com_matching >= self.quorum

    # -- transitions --------------------------------------------------------

    def _maybe_advance(self) -> List[Action]:
        if self.qc_mode:
            # quorum formation happens at the primary via QC aggregation;
            # local vote counts must not drive transitions
            return self._maybe_advance_qc()
        out: List[Action] = []
        # the is-not-None re-checks are implied by prepared()/committed()
        # (a quorum fixes the digest and admits the block) but let mypy
        # prove the Action fields are never None
        if (
            self.stage == Stage.PRE_PREPARED
            and self.prepared()
            and self.digest is not None
        ):
            self.stage = Stage.PREPARED
            out.append(SendCommit(self.view, self.seq, self.digest))
        if (
            self.stage == Stage.PREPARED
            and self.committed()
            and self.digest is not None
            and self.block is not None
        ):
            self.stage = Stage.COMMITTED
            if not self.executed:
                self.executed = True
                out.append(
                    ExecuteBlock(self.view, self.seq, self.digest, self.block)
                )
        return out

    # -- QC-mode transitions -------------------------------------------------

    def on_prepare_qc(self, qc: QuorumCert) -> List[Action]:
        """A VERIFIED prepare QC for this slot. The commit share is only
        emitted once our own pre-prepare is also held (_maybe_advance_qc):
        a replica in the commit quorum must be able to produce a P-set
        entry ({pre_prepare, prepare_qc}) in a view change, or the
        quorum-intersection argument that protects committed blocks
        across views breaks."""
        if (qc.view, qc.seq) != (self.view, self.seq):
            return []
        if self.digest is not None and qc.digest != self.digest:
            return []  # conflicts with the pre-prepare we admitted
        if self.prepare_qc is not None:
            return []
        self.prepare_qc = qc
        if self.digest is None:
            self.digest = qc.digest
            self._recount_matching()
        return self._maybe_advance_qc()

    def on_commit_qc(self, qc: QuorumCert) -> List[Action]:
        if (qc.view, qc.seq) != (self.view, self.seq):
            return []
        if self.digest is not None and qc.digest != self.digest:
            return []
        if self.commit_qc is not None:
            return []
        self.commit_qc = qc
        if self.digest is None:
            self.digest = qc.digest
            self._recount_matching()
        return self._maybe_advance_qc()

    def _maybe_advance_qc(self) -> List[Action]:
        out: List[Action] = []
        if (
            self.prepare_qc is not None
            and self.pre_prepare is not None  # must be able to prove the
            # slot in a view change (prepared_proof needs the block)
            and self.stage in (Stage.IDLE, Stage.PRE_PREPARED)
            and self.digest is not None  # fixed by the QC admission
        ):
            self.stage = Stage.PREPARED
            out.append(SendCommit(self.view, self.seq, self.digest))
        if (
            self.commit_qc is not None
            and self.stage is not Stage.COMMITTED
            # a commit QC subsumes the prepare QC (2f+1 replicas held one);
            # execution still needs the block content from the pre-prepare
            and self.block is not None
            and self.digest is not None
            and not self.executed
        ):
            self.stage = Stage.COMMITTED
            self.executed = True
            out.append(
                ExecuteBlock(self.view, self.seq, self.digest, self.block)
            )
        return out

    # -- hole repair ---------------------------------------------------------

    def adopt_block(self, block: List[Dict[str, Any]]) -> List[Action]:
        """Catch-up refill: a self-authenticating block (its digest must
        match the digest a verified quorum certificate fixed for this
        slot) for a slot whose pre-prepare was never delivered — the
        steady-state hole SlotFetch repairs (replica._on_block_reply).
        Never overrides an admitted block; emits at most the execution
        transition (no votes)."""
        if self.block is not None or self.digest is None:
            return []
        if PrePrepare.block_digest(block) != self.digest:
            return []
        self.block = block
        return self._maybe_advance_qc() if self.qc_mode else []

    # -- view-change support -------------------------------------------------

    def _detached_pre_prepare(self) -> Dict[str, Any]:
        """The pre-prepare with its block stripped: the digest (which the
        signature covers — PrePrepare.signing_payload detaches the block)
        binds the content, so certificates ship digests and receivers
        refill blocks locally or via BlockFetch. This is what keeps
        VIEW-CHANGE/NEW-VIEW wires small under load."""
        if self.pre_prepare is None:  # callers guard; keep mypy honest
            raise RuntimeError("no pre-prepare admitted for this slot")
        d = self.pre_prepare.to_dict()
        d["block"] = []
        return d

    def prepared_proof(self) -> Optional[Dict[str, Any]]:
        """If prepared, the certificate a VIEW-CHANGE message carries for
        this slot (Castro-Liskov P-set): {pre-prepare, 2f+1 prepares} —
        or, in QC mode, {pre-prepare, prepare_qc}: the aggregate IS the
        2f+1-signer certificate, one pairing check instead of 2f+1
        signature checks and a fraction of the wire bytes. Pre-prepares
        ship digest-only (blocks detached)."""
        if self.qc_mode:
            if self.prepare_qc is None or self.pre_prepare is None:
                return None
            if self.prepare_qc.digest != self.pre_prepare.digest:
                return None
            return {
                "pre_prepare": self._detached_pre_prepare(),
                "prepare_qc": self.prepare_qc.to_dict(),
            }
        if not self.prepared():
            return None
        votes = [
            p.to_dict()
            for p in self.prepares.values()
            if p.digest == self.digest
        ]
        return {
            "pre_prepare": self._detached_pre_prepare(),
            "prepares": votes[: self.quorum],
        }
