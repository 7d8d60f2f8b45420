"""Speculative pipelined execution with fault-tolerant rollback.

Commit latency at depth is pipeline depth, not crypto. This
module adopts Proof-of-Execution's fault-tolerant speculation (PAPERS:
arxiv 1911.00838): a replica executes a block when the slot reaches
PREPARED — two message delays before the commit certificate — against a
disposable FORK of the application state (app.ForkableApp), and replies
to the clients immediately with a signed speculative mark
(messages.Reply.spec). The client accepts 2f+1 matching speculative
replies as a fast answer: 2f+1 speculators are 2f+1 preparers, and by
quorum intersection no future view's NEW-VIEW certificate can install a
different block at that slot — a spec-quorum answer is final-safe even
though any INDIVIDUAL replica's speculation can still lose.

What an individual replica speculated CAN lose two ways, and both roll
back to the last committed anchor:

- **finalize divergence** — ordered execution reaches the slot with a
  different digest than the one speculated (a view change replaced the
  block; the speculated one was prepared by <= f replicas whose
  VIEW-CHANGEs the NEW-VIEW certificate excluded);
- **install divergence** — a NEW-VIEW's O-set re-issues a different
  digest (or a no-op) for a speculated seq; detected at install, before
  any of the re-issued pre-prepares replay.

Rollback discards the fork (O(1) — app.ForkableApp.rollback), drops
every speculated slot above the committed frontier, and re-speculates
the still-PREPARED instances in order — "walk back to the last
committed anchor, re-execute from the certified prefix".

Out-of-order speculation: a slot that prepares ABOVE an execution hole
may still speculate when every gap slot is COMMITTED with a known block
(parked in ``replica.ready`` behind the hole — the common repair-wait
shape) and the candidate's read/write sets are disjoint from every gap
block's (Application.rw_sets). Commitment fixes the gap blocks forever,
so disjointness proven against them is proof the speculative result
equals the final one — never a guess against a block that could change.

Safety invariant (the sim oracle's target): speculative state NEVER
leaks into a checkpoint digest or a committed reply. The committed
surface of ForkableApp is fork-blind by construction; ``DEFECTS`` below
re-arms the leak (promote-the-fork-on-rollback) as a planted defect so
the coverage-guided sim search can prove its oracle catches it
(tests/sim_repros/spec_rollback_viewchange.json).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .. import clock, spans
from ..app import ForkableApp
from ..messages import Reply

log = logging.getLogger("pbft.speculation")

# replica.RECONFIG_PREFIX, duplicated here (not imported) because
# replica imports this module; tests pin the two against drift
RECONFIG_PREFIX_ = "__reconfig__ "

#: Planted-defect knobs for the simulation search (mirrors
#: statesync.DEFECTS). "spec_leak": after the first rollback, checkpoint
#: snapshots are cut from the speculative FORK instead of the committed
#: state (checkpoint_app_snapshot) — the exact bug shape the
#: spec-state-excluded-from-checkpoint oracle catches: honest replicas
#: speculate on different timings, so fork-tainted snapshots diverge
#: their checkpoint digests and the audit plane's I2 invariant fires
#: among honest nodes (sim failure class ``safety:honest-accused``).
DEFECTS: Set[str] = set()


@dataclass
class SpecSlot:
    """One speculated slot: what was executed, against what digest."""

    seq: int
    view: int
    digest: str
    #: (client_id, timestamp) -> speculative result, for the requests
    #: this slot actually applied (replays mirror-skipped like finalize)
    results: Dict[Tuple[str, int], str] = field(default_factory=dict)
    reads: FrozenSet[str] = frozenset()
    writes: FrozenSet[str] = frozenset()
    ooo: bool = False  # executed ahead of a committed gap


class SpeculationEngine:
    """Per-replica speculation state machine, owned by a Replica.

    All entry points are called from the replica's event loop; the
    engine never sends consensus traffic — only client replies — and
    never touches the committed app except through finalize-time
    catch-up of the fork (and the planted leak defect)."""

    def __init__(self, replica) -> None:
        self.r = replica
        self.app = ForkableApp(replica.app)
        # speculation is only worth its bookkeeping when the app can be
        # forked at all; EchoApp/KVStore can, exotic apps may not
        self.enabled = self.app.forkable()
        # cap on concurrently open speculative slots (knob
        # spec.max_depth): bounds the rollback blast radius — every
        # open slot is work a view-change divergence can discard
        self.max_depth = 64
        self.slots: Dict[int, SpecSlot] = {}
        # set by rollback(), consumed by re_speculate(): the execute
        # drain re-speculates only after a rollback actually discarded
        # work (never a per-commit instance scan on the healthy path)
        self.needs_respec = False
        self.rolled_back_once = False  # arms the spec_leak defect

    # ------------------------------------------------------------------
    # speculate at PREPARED
    # ------------------------------------------------------------------

    def on_prepared(self, inst) -> Optional[List[Reply]]:
        """A slot just reached PREPARED here: execute it speculatively
        if the fork can be kept consistent, and return the speculative
        replies to transmit (None/empty = nothing to send). The caller
        (replica._perform) authenticates and sends them."""
        r = self.r
        if not self.enabled or r.retired or r.vc.in_view_change:
            return None
        seq = inst.seq
        if seq <= r.executed_seq or seq in self.slots:
            return None
        if inst.block is None or inst.digest is None:
            return None
        if self.max_depth and len(self.slots) >= self.max_depth:
            r.metrics["spec_skipped_depth"] += 1
            return None
        reqs = r._validate_block(inst.block, inst.digest)
        if reqs is None:
            return None
        if any(
            req.operation.startswith(RECONFIG_PREFIX_) for req in reqs
        ):
            # membership changes have side effects outside the app
            # (staging, epoch activation): never speculate them
            r.metrics["spec_skipped_reconfig"] += 1
            return None
        rw = self._block_rw(reqs)
        ooo = False
        gap = [
            g
            for g in range(r.executed_seq + 1, seq)
            if g not in self.slots
        ]
        if gap:
            if rw is None:
                return None  # unparsable ops: no disjointness proof
            gap_rw = self._committed_gap_rw(gap)
            if gap_rw is None:
                r.metrics["spec_skipped_gap"] += 1
                return None  # a gap slot is not committed-with-block
            reads, writes = rw
            g_reads, g_writes = gap_rw
            if (writes & (g_reads | g_writes)) or (reads & g_writes):
                r.metrics["spec_skipped_conflict"] += 1
                return None
            ooo = True
        slot = SpecSlot(
            seq=seq,
            view=inst.view,
            digest=inst.digest,
            reads=rw[0] if rw else frozenset(),
            writes=rw[1] if rw else frozenset(),
            ooo=ooo,
        )
        replies: List[Reply] = []
        # designated speculative repliers: the client needs 2f+1
        # matching marks, so the rotation window is quorum + spares
        # (cfg.spec_repliers); everyone still executes — the fork must
        # stay consistent on every replica regardless of who transmits
        designated = (r._index - seq) % r.cfg.n < r.cfg.spec_repliers
        for req in reqs:
            recent = r.recent_replies.get(req.client_id, {})
            if (
                req.timestamp in recent
                or req.timestamp
                <= r.client_watermark.get(req.client_id, 0)
            ):
                continue  # replay: finalize will skip it identically
            result = self.app.apply_spec(req.operation)
            slot.results[(req.client_id, req.timestamp)] = result
            if designated:
                replies.append(
                    Reply(
                        view=inst.view,
                        seq=seq,
                        client_id=req.client_id,
                        timestamp=req.timestamp,
                        result=result,
                        spec=1,
                        epoch=r.cfg.epoch,
                    )
                )
        self.slots[seq] = slot
        r.metrics["spec_executed"] += 1
        r.metrics["spec_requests"] += len(slot.results)
        if ooo:
            r.metrics["spec_ooo"] += 1
        now = clock.now()
        if inst.t_started:
            # the speculative half of the phase.execute split: admission
            # -> speculative reply, directly comparable per percentile
            # against execute.final (admission -> applied in order)
            dur = now - inst.t_started
            r.stats.spec_reply_ms.record(dur * 1e3)
            spans.record(
                spans.EXECUTE_SPEC, dur,
                node=r.id, view=inst.view, seq=seq,
            )
        return replies

    def _block_rw(
        self, reqs
    ) -> Optional[Tuple[FrozenSet[str], FrozenSet[str]]]:
        rw_fn = getattr(self.app, "rw_sets", None)
        if not callable(rw_fn):
            return None
        reads: Set[str] = set()
        writes: Set[str] = set()
        for req in reqs:
            rw = rw_fn(req.operation)
            if rw is None:
                return None
            reads |= rw[0]
            writes |= rw[1]
        return frozenset(reads), frozenset(writes)

    def _committed_gap_rw(
        self, gap: List[int]
    ) -> Optional[Tuple[FrozenSet[str], FrozenSet[str]]]:
        """Union read/write sets of the gap slots — valid ONLY when
        every gap slot holds a commit certificate with a known block
        (replica.ready): commitment fixes the block, so the disjointness
        proof cannot be invalidated by a later view."""
        r = self.r
        reads: Set[str] = set()
        writes: Set[str] = set()
        for g in gap:
            act = r.ready.get(g)
            if act is None:
                return None
            reqs = r._validate_block(act.block, act.digest)
            if reqs is None:
                return None
            rw = self._block_rw(reqs)
            if rw is None:
                return None
            reads |= rw[0]
            writes |= rw[1]
        return frozenset(reads), frozenset(writes)

    # ------------------------------------------------------------------
    # finalize (ordered execution reached the slot)
    # ------------------------------------------------------------------

    def before_finalize(self, act) -> None:
        """Divergence gate, run BEFORE the block applies to committed
        state: a speculated digest losing to the committed one means the
        whole fork suffix was built on a block that never happened."""
        slot = self.slots.get(act.seq)
        if slot is not None and slot.digest != act.digest:
            self.rollback("finalize-divergence")

    def after_finalize(
        self, act, final_results: Dict[Tuple[str, int], str]
    ) -> None:
        """The slot just applied to committed state with these results.
        Confirm (or roll back) the speculation, and keep the fork in
        lockstep across slots that were never speculated."""
        r = self.r
        slot = self.slots.pop(act.seq, None)
        if slot is not None:
            if slot.results == final_results:
                r.metrics["spec_confirmed"] += 1
                return
            # same digest (before_finalize passed) but different
            # results: the fork state under the speculation differed
            # from the committed prefix — e.g. a replay folded between
            # speculation and finalize. Rare; always safe to walk back.
            self.rollback("finalize-result-mismatch")
            return
        if not self.enabled or not self.app.spec_open():
            return
        # an unspeculated slot committed under open speculation: the
        # fork must absorb it (in commuted position — out-of-order
        # speculation only crossed gaps proven disjoint) or die
        later = [s for s in self.slots.values() if s.seq > act.seq]
        if not later:
            # nothing speculative remains beyond this slot (slot keys
            # are always > executed_seq, so the map is empty here):
            # cheapest consistency is a fresh anchor on next use
            self.app.rollback()
            return
        reqs = r._validate_block(act.block, act.digest)
        rw = self._block_rw(reqs) if reqs is not None else None
        if rw is None or any(
            (rw[1] & (s.reads | s.writes)) or (rw[0] & s.writes)
            for s in later
        ):
            self.rollback("gap-conflict")
            return
        for req in reqs:
            if (req.client_id, req.timestamp) in final_results:
                self.app.apply_spec(req.operation)

    # ------------------------------------------------------------------
    # rollback + re-speculation
    # ------------------------------------------------------------------

    def rollback(self, reason: str) -> None:
        """Walk speculative state back to the last committed anchor."""
        r = self.r
        discarded = [s for s in self.slots if s > r.executed_seq]
        self.rolled_back_once = True
        self.app.rollback()
        self.slots.clear()
        if discarded:
            self.needs_respec = True
            r.metrics["spec_rolled_back"] += len(discarded)
            r.metrics["spec_rollbacks"] += 1
            log.debug(
                "%s: speculation rollback (%s): %d slot(s) from %d",
                r.id, reason, len(discarded), min(discarded),
            )

    def re_speculate(self) -> List[Reply]:
        """After a rollback: re-execute the certified prefix — every
        still-PREPARED instance above the committed frontier, in slot
        order. Returns the fresh speculative replies to transmit."""
        r = self.r
        self.needs_respec = False
        if not self.enabled or r.vc.in_view_change:
            return []
        out: List[Reply] = []
        prepared = sorted(
            (
                inst
                for (view, seq), inst in r.instances.items()
                if view == r.view
                and seq > r.executed_seq
                and seq not in self.slots
                and not inst.executed
                and (
                    inst.prepare_qc is not None
                    if inst.qc_mode
                    else inst.prepared()
                )
            ),
            key=lambda i: i.seq,
        )
        for inst in prepared:
            replies = self.on_prepared(inst)
            if replies:
                out.extend(replies)
        return out

    # ------------------------------------------------------------------
    # external invalidation edges
    # ------------------------------------------------------------------

    def on_new_view_install(
        self, o_entries: List[Tuple[int, str]]
    ) -> None:
        """NEW-VIEW install: the O-set is the certified truth for every
        in-window slot. Any speculated seq whose digest LOSES (different
        digest, or a no-op where we speculated content, or a seq beyond
        the O-set's horizon — a proposal that died with its view) rolls
        the whole speculative suffix back; matching slots survive and
        will confirm at finalize under the new view's re-issues."""
        if not self.slots:
            return
        o_map = dict(o_entries)
        o_max = max(o_map, default=0)
        for seq, slot in sorted(self.slots.items()):
            issued = o_map.get(seq)
            if (issued is None and seq > o_max) or (
                issued is not None and issued != slot.digest
            ):
                self.r.metrics["spec_install_divergence"] += 1
                self.rollback("new-view-divergence")
                return

    def on_state_transfer(self, seq: int) -> None:
        """A certified snapshot installed at ``seq``: the committed
        anchor jumped, so every open speculation is anchored on stale
        state. The replica restores through this engine's ForkableApp
        (replica.install_snapshot), whose restore() drops the fork
        atomically with the anchor move; here we reconcile the slot
        bookkeeping and drop the fork again defensively (harmless when
        already closed) in case a future restore path bypasses the
        wrapper."""
        if self.slots:
            survivors = [s for s in self.slots if s > seq]
            if survivors:
                self.rollback("state-transfer")
            else:
                self.slots.clear()
        self.app.rollback()

    def on_epoch(self, boundary: int) -> None:
        """A membership epoch activated at ``boundary``: slots above it
        were re-filtered to the new quorum (replica._reconcile_boundary_
        instances) and may no longer be prepared — their speculation is
        unjustified until they re-prepare under the new epoch."""
        if any(s > boundary for s in self.slots):
            self.rollback("epoch-boundary")

    def checkpoint_app_snapshot(self) -> str:
        """The application snapshot a checkpoint must embed: ALWAYS the
        committed state — unless the ``spec_leak`` planted defect is
        armed, in which case, after the first rollback, the snapshot is
        cut from the speculative FORK (the exact once-plausible bug the
        spec-state-excluded-from-checkpoint oracle exists to catch:
        replicas speculate on different timings, so a fork-tainted
        snapshot diverges honest checkpoint digests and the audit
        plane's I2 invariant fires among honest nodes)."""
        if (
            "spec_leak" in DEFECTS
            and self.rolled_back_once
            and self.app.spec_open()
        ):
            self.r.metrics["spec_leaks_injected"] += 1
            return self.app._fork.snapshot()
        return self.r.app.snapshot()

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def snapshot(self) -> Dict[str, int]:
        return {
            "enabled": int(self.enabled),
            "max_depth": self.max_depth,
            "open_slots": len(self.slots),
            "fork_open": int(self.app.spec_open()),
            "forks_built": self.app.forks_built,
        }
