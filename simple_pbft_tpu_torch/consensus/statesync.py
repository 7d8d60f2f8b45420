"""Checkpoint state-transfer protocol.

A rejoining or lagging replica catches up from the latest 2f+1-certified
stable checkpoint instead of replaying the log. Before this module, the
transfer was one monolithic StateResponse frame: a multi-MB snapshot
either arrived whole or not at all — one lost frame restarted the whole
transfer, a WAN-shaped link serialized minutes of consensus traffic
behind it, and a byzantine responder wasted a full snapshot of bandwidth
per lie. Here the transfer is:

- **bounded**: the snapshot travels in CHUNK_BYTES pieces, each an
  ordinary data-plane frame that fits any transport's caps and shares
  links fairly with consensus traffic;
- **resumable**: received chunks survive peer rotation and retry — a
  lost chunk costs one chunk, not the transfer;
- **digest-verified**: the assembled snapshot must hash to the
  2f+1-certified checkpoint digest (the same authority the legacy path
  used), so a forged chunk stream (faults.ForgedSnapshotServer) is
  detected at assembly — the certified digest, not any responder, is
  trusted. Because a multi-server assembly cannot attribute the lie,
  detection switches the transfer to SOLO mode: the whole snapshot is
  re-fetched from one peer at a time, so the next mismatch convicts
  that peer definitively (every byte came from it) and each round
  eliminates one liar — bounded by the peer count, with an honest
  holder guaranteed (2f+1 certified). Conflicting chunk-count claims
  between servers trigger the same isolation;
- **suffix-completing**: after install the replica's ordinary slot-probe
  chain fetches the log suffix above ``stable_seq`` (bounded by one
  watermark window by construction — nothing beyond H can have
  committed), so total transfer volume is snapshot + one window.

Triggers (all through replica._stabilize, which delegates here):
- watermark-gap detection: a checkpoint quorum forms at a seq beyond our
  execution frontier (the steady-state lag case);
- NEW-VIEW install: the certificate proves an h whose state we never
  had (viewchange.on_new_view's _stabilize calls);
- cold-start rejoin: a restarted process (tests/test_process_failover)
  learns the committee's stable checkpoint from the first checkpoint
  quorum or view-change certificate it sees.

Volume accounting for the acceptance bound rides in replica.metrics:
``statesync_bytes`` (chunk payload received), ``statesync_chunks``,
``statesync_restarts`` (digest-mismatch recoveries).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional, Set

from .. import clock
from ..messages import StateChunkReply, StateChunkRequest

log = logging.getLogger("pbft.statesync")

#: Planted-defect knobs for simulation validation: the
#: schedule-search loop must be proven able to FIND a real bug class,
#: so known-fixed defects can be re-armed here (by the sim harness
#: only — sim.Scenario.defects) and hunted by coverage-guided search.
#: Production/test code never sets this. Known knobs:
#:   "sync_abandon_leak" — re-opens an old wedge: an abandoned
#:   transfer keeps ``pending_sync`` held, so _stabilize's dedup guard
#:   swallows retransmitted checkpoint quorums at the same seq and a
#:   committee that needs this replica for quorum wedges forever.
DEFECTS: Set[str] = set()

CHUNK_BYTES = 256 * 1024
MAX_CHUNKS = 4096  # 1 GiB snapshot ceiling — beyond this the deployment
# needs an out-of-band bulk channel, not a consensus transport
WINDOW = 4  # chunk requests in flight at once
RETRY_S = 0.4  # retry tick: re-request missing chunks, rotate peers
MAX_ROUNDS = 64  # consecutive NO-PROGRESS retry ticks before abandoning
# (reset on every received chunk; a later quorum re-triggers begin())
SOLO_ROTATE_TICKS = 4  # no-progress ticks before a SILENT solo peer is
# rotated out (rotation never convicts — only a digest mismatch does)
# Server-side per-requester token bucket (DoS bound). The burst admits a
# full pipelined WINDOW of back-to-back requests plus their immediate
# follow-ups — a fixed per-request cooldown here would silently drop the
# round-robin's same-peer bursts and cap transfers at ~1 chunk per peer
# per RETRY_S tick regardless of link capacity.
SERVE_BURST = 2 * WINDOW  # bucket capacity (requests)
SERVE_RATE = 64.0  # sustained refill (requests/s per requester)


class StateSync:
    """Per-replica chunked state-transfer driver (client AND server
    side). All entry points run on the replica's event loop."""

    def __init__(self, replica) -> None:
        self.r = replica
        # active transfer: None or mutable dict (seq, digest, peers,
        # total, chunks, chunk_src, bad_peers, rounds)
        self.active: Optional[dict] = None
        self._retry_task: Optional[asyncio.Task] = None
        # sender -> (tokens, last-refill monotonic) serve bucket
        self._serve_bucket: Dict[str, tuple] = {}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def cancel(self) -> None:
        """Abandon any transfer (replica kill/stop)."""
        self.active = None
        if self._retry_task is not None:
            self._retry_task.cancel()
            self._retry_task = None

    @property
    def syncing(self) -> bool:
        return self.active is not None

    # ------------------------------------------------------------------
    # requester side
    # ------------------------------------------------------------------

    async def begin(self, seq: int, digest: str,
                    certifiers: Optional[List[str]] = None) -> None:
        """Start (or retarget) a transfer toward the certified snapshot
        at ``seq``. A newer target supersedes an in-flight transfer —
        the committee has moved on and the old snapshot may already be
        GC'd at every peer."""
        if self.active is not None and self.active["seq"] >= seq:
            return  # already chasing this checkpoint (or a later one)
        peers = [p for p in (certifiers or []) if p != self.r.id]
        if not peers:
            peers = [p for p in self.r.cfg.replica_ids if p != self.r.id]
        self.active = {
            "seq": seq,
            "digest": digest,
            "peers": peers,
            "bad_peers": set(),
            "total": None,  # learned from the first reply
            "total_src": None,  # who claimed it (conflict attribution)
            "chunks": {},  # index -> data
            "chunk_src": {},  # index -> serving peer (forgery forensics)
            "inflight": {},  # index -> monotonic time requested
            "rr": 0,
            "rounds": 0,
            "solo": None,  # SOLO mode: sole serving peer after a lie
        }
        self.r.metrics["statesync_transfers"] += 1
        await self._request_missing()
        if self._retry_task is None or self._retry_task.done():
            self._retry_task = asyncio.get_running_loop().create_task(
                self._retry_loop()
            )

    def _peer_ring(self, a: dict) -> List[str]:
        if a["solo"] is not None:
            return [a["solo"]]
        good = [p for p in a["peers"] if p not in a["bad_peers"]]
        if not good:
            # every certifier burned (or none known): widen to the whole
            # committee minus proven liars — 2f+1 certified, so at least
            # f+1 honest holders exist
            good = [
                p for p in self.r.cfg.replica_ids
                if p != self.r.id and p not in a["bad_peers"]
            ]
        return good or [p for p in self.r.cfg.replica_ids if p != self.r.id]

    def _rotate_solo(self, a: dict) -> None:
        """Point SOLO mode at the next candidate peer (round-robin over
        everyone not definitively convicted)."""
        a["solo"] = None
        ring = self._peer_ring(a)
        a["solo"] = ring[a["rr"] % len(ring)]
        a["rr"] += 1

    def _isolate(self, a: dict, suspects: Set[str]) -> None:
        """A lie was detected (forged assembly or conflicting chunk-count
        claims) — restart the transfer in SOLO mode: every chunk comes
        from ONE peer at a time, so the next mismatch convicts that peer
        definitively. ``suspects`` are peers already individually proven
        dishonest (every byte of the detected lie came from them) —
        excluded for the transfer's lifetime. Each solo round through a
        liar eliminates it, so recovery is bounded by the peer count and
        an honest holder (2f+1 certified the seq) is always reached."""
        a["bad_peers"] |= suspects
        a["chunks"].clear()
        a["chunk_src"].clear()
        a["inflight"].clear()
        a["total"] = None
        a["total_src"] = None
        self._rotate_solo(a)
        self.r.metrics["statesync_restarts"] += 1

    def _missing(self, a: dict) -> List[int]:
        if a["total"] is None:
            return [0]
        return [i for i in range(a["total"]) if i not in a["chunks"]]

    async def _request_missing(self) -> None:
        a = self.active
        if a is None:
            return
        ring = self._peer_ring(a)
        now = clock.now()
        sent = 0
        for idx in self._missing(a):
            if sent >= WINDOW:
                break
            t_req = a["inflight"].get(idx)
            if t_req is not None and now - t_req < RETRY_S:
                continue  # still plausibly in flight
            peer = ring[a["rr"] % len(ring)]
            a["rr"] += 1
            req = StateChunkRequest(seq=a["seq"], index=idx)
            self.r.signer.sign_msg(req)
            a["inflight"][idx] = now
            self.r.metrics["statesync_chunk_requests"] += 1
            await self.r.transport.send(peer, req.to_wire())
            sent += 1

    async def _retry_loop(self) -> None:
        """Re-request missing chunks on a fixed tick until the transfer
        completes or gives up. The tick rotates peers, so a silent
        (crashed, partitioned, byzantine-muted) server costs one tick,
        not the transfer."""
        try:
            while self.active is not None:
                await clock.sleep(RETRY_S)
                a = self.active
                if a is None:
                    return
                a["rounds"] += 1
                # observability (and the sim search's fitness ramp
                # toward starvation interleavings): the worst
                # consecutive no-progress stretch any transfer saw
                if a["rounds"] > self.r.metrics.get(
                    "statesync_stall_ticks_max", 0
                ):
                    self.r.metrics["statesync_stall_ticks_max"] = a["rounds"]
                if a["rounds"] > MAX_ROUNDS:
                    # abandon: the next checkpoint quorum (or NEW-VIEW)
                    # re-triggers _stabilize -> begin with fresh peers.
                    # pending_sync must be released too — _stabilize's
                    # dedup guard (pending_sync[0] < seq) would otherwise
                    # swallow retransmitted quorums at the SAME seq, and
                    # a committee that cannot advance without us never
                    # produces a later one: wedged forever
                    self.r.metrics["statesync_abandoned"] += 1
                    if "sync_abandon_leak" not in DEFECTS:
                        ps = self.r.pending_sync
                        if ps is not None and ps[0] <= a["seq"]:
                            self.r.pending_sync = None
                    self.active = None
                    return
                if (
                    a["solo"] is not None
                    and a["rounds"] % SOLO_ROTATE_TICKS == 0
                ):
                    # the solo peer is silent (crashed, partitioned,
                    # muted): move on without convicting it — received
                    # chunks are kept; chunk_src still attributes them,
                    # so a later mismatch only convicts when the failed
                    # assembly had a single source
                    self._rotate_solo(a)
                    a["inflight"].clear()
                await self._request_missing()
        except asyncio.CancelledError:
            pass
        finally:
            self._retry_task = None

    async def on_chunk_reply(self, msg: StateChunkReply) -> None:
        a = self.active
        if a is None or msg.seq != a["seq"]:
            return
        if msg.sender in a["bad_peers"]:
            return
        if a["solo"] is not None and msg.sender != a["solo"]:
            return  # late multi-source reply must not pollute attribution
        if not (0 < msg.total <= MAX_CHUNKS) or not (
            0 <= msg.index < msg.total
        ):
            return
        if len(msg.data) > CHUNK_BYTES:
            # an honest server never exceeds CHUNK_BYTES per chunk, and
            # the lie is individually attributable — convict BEFORE
            # storing a byte, or a forged stream of transport-cap-sized
            # chunks balloons memory long before the assembly digest
            # check could catch it
            self.r.metrics["statesync_forged"] += 1
            self._isolate(a, {msg.sender})
            await self._request_missing()
            return
        if a["total"] is None:
            a["total"] = msg.total
            a["total_src"] = msg.sender
        elif msg.total != a["total"]:
            # servers disagree on the chunk count: someone lies. Convict
            # only on clean attribution (the SAME peer contradicting its
            # own earlier claim); two distinct claimants can't be told
            # apart here — SOLO mode re-learns the count one peer at a
            # time and the digest check settles it
            suspects = (
                {msg.sender} if msg.sender == a["total_src"] else set()
            )
            self._isolate(a, suspects)
            await self._request_missing()
            return
        if msg.index in a["chunks"]:
            return  # duplicate (late retry answer)
        a["chunks"][msg.index] = msg.data
        a["chunk_src"][msg.index] = msg.sender
        a["inflight"].pop(msg.index, None)
        a["rounds"] = 0  # progress: MAX_ROUNDS bounds the STALL, not the
        # transfer — a large snapshot arriving steadily must never abort
        self.r.metrics["statesync_chunks"] += 1
        self.r.metrics["statesync_bytes"] += len(msg.data)
        if len(a["chunks"]) >= a["total"]:
            await self._assemble(a)
        else:
            await self._request_missing()

    async def _assemble(self, a: dict) -> None:
        from ..app import snapshot_digest

        snap = "".join(a["chunks"][i] for i in range(a["total"]))
        if snapshot_digest(snap) != a["digest"]:
            # forged (or torn) transfer: the certified digest is the
            # authority. A multi-source assembly cannot attribute the
            # lie, so nobody is convicted — the transfer drops to SOLO
            # mode (one peer at a time) where the NEXT mismatch convicts
            # its sole source definitively. A single-source failure
            # convicts right here.
            self.r.metrics["statesync_forged"] += 1
            srcs = set(a["chunk_src"].values())
            self._isolate(a, srcs if len(srcs) == 1 else set())
            log.warning(
                "%s: statesync digest mismatch at seq %d (sources %s); "
                "solo mode via %s, convicted %s",
                self.r.id, a["seq"], sorted(srcs), a["solo"],
                sorted(a["bad_peers"]),
            )
            await self._request_missing()
            return
        seq, digest = a["seq"], a["digest"]
        self.active = None
        installed = await self.r.install_snapshot(seq, digest, snap)
        if installed:
            # log-suffix completion: everything above the snapshot that
            # already committed is at most one watermark window away;
            # the ordinary probe chain fetches it without special cases
            await self.r.send_slot_probe()

    # ------------------------------------------------------------------
    # server side
    # ------------------------------------------------------------------

    async def on_chunk_request(self, msg: StateChunkRequest) -> None:
        now = clock.now()
        tokens, last = self._serve_bucket.get(
            msg.sender, (float(SERVE_BURST), now)
        )
        tokens = min(float(SERVE_BURST), tokens + (now - last) * SERVE_RATE)
        if tokens < 1.0:
            self.r.metrics["statesync_throttled"] += 1
            return
        self._serve_bucket[msg.sender] = (tokens - 1.0, now)
        if len(self._serve_bucket) > 4096:  # bounded (hostile sender ids)
            self._serve_bucket.pop(next(iter(self._serve_bucket)))
        snap = self.r.snapshots.get(msg.seq)
        if snap is None:
            return  # GC'd or never held: requester rotates elsewhere
        total = max(1, -(-len(snap) // CHUNK_BYTES))
        if total > MAX_CHUNKS or not (0 <= msg.index < total):
            return
        reply = StateChunkReply(
            seq=msg.seq,
            index=msg.index,
            total=total,
            data=snap[msg.index * CHUNK_BYTES:(msg.index + 1) * CHUNK_BYTES],
        )
        self.r.signer.sign_msg(reply)
        self.r.metrics["statesync_chunks_served"] += 1
        await self.r.transport.send(msg.sender, reply.to_wire())
