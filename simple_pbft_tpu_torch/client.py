"""Client library: submit requests, collect f+1 matching replies.

The reference client (client.go:12-34) fire-and-forgets one request at the
primary and exits — no reply collection, no retry, no f+1 matching; all
called out in its author's gap list (需要改进的地方.md:3-9). This client:

- signs requests (client identities have keys like replicas);
- sends to the current primary, rebroadcasts to ALL replicas on timeout
  (the PBFT liveness path that eventually triggers a view change);
- waits for f+1 replies with matching (timestamp, result) before
  accepting — f+1 guarantees at least one honest replica's word.
"""

from __future__ import annotations

import asyncio
import itertools
import random
from collections import OrderedDict, defaultdict, deque
from typing import Dict, Optional, Tuple

from . import clock, spans
from .config import CommitteeConfig, config_from_doc
from .crypto.signer import Signer
from .crypto.verifier import BatchItem, Verifier, best_cpu_verifier
from .messages import ConfigFetch, ConfigReply, Message, Reply, Request
from .transport.base import Transport


class SupersededError(Exception):
    """f+1 replicas answered with Reply.superseded=1: the request's
    timestamp fell under a folded checkpoint watermark and the operation
    was NOT applied by this submission. Whether to resubmit is the
    application's call — the same answer is given for a request that DID
    execute long ago but whose cached reply was folded away, so a blind
    automatic retry could apply a non-idempotent operation twice."""


class Client:
    def __init__(
        self,
        client_id: str,
        cfg: CommitteeConfig,
        seed: bytes,
        transport: Transport,
        verifier: Optional[Verifier] = None,
        request_timeout: float = 1.0,
        hedge: int = 0,
        backoff_factor: float = 1.6,
        backoff_cap: float = 0.0,
        jitter: float = 0.1,
    ) -> None:
        self.id = client_id
        self.cfg = cfg
        self.signer = Signer(client_id, seed)
        self.transport = transport
        self.verifier = verifier if verifier is not None else best_cpu_verifier()
        self.request_timeout = request_timeout
        # Retry policy: attempt k waits request_timeout *
        # backoff_factor**k (capped), +/- jitter fraction. Exponential
        # backoff keeps a shedding committee from being re-flooded at a
        # fixed cadence by every starving client at once (the r5 chaos
        # cell's retry waves); jitter decorrelates the waves themselves.
        # backoff_cap <= 0 means 8x the CURRENT request_timeout (benches
        # mutate request_timeout after construction). factor 1.0 restores
        # the old fixed-interval behavior exactly.
        self.backoff_factor = backoff_factor
        self.backoff_cap = backoff_cap
        self.jitter = jitter
        # deterministic per-client jitter stream: fault-injection runs
        # replay identically for a given (client set, seed) pair
        self._rng = random.Random(int.from_bytes(seed[:8], "big") ^ 0x5BD1)
        # observability: retransmissions sent, requests that only
        # completed after at least one retry (the "shed then recovered"
        # signature — distinguishes overload shedding from real loss)
        self.metrics: Dict[str, int] = defaultdict(int)
        # Hedged first send: also deliver each request to `hedge` backups
        # (rotating), who relay it to the primary and arm their failover
        # timers on first receipt. Kills the worst-case failover tail
        # where a crashing primary was the ONLY replica that knew about
        # the in-flight batch — recovery then waits a full client
        # request_timeout before anyone even suspects. Costs hedge+1
        # sends per request instead of 1 (still O(1), not a broadcast).
        self.hedge = hedge
        # per-replica MAC keys: replies carry an HMAC tag instead of a
        # signature when both ends publish kx keys (crypto/mac.py)
        from .crypto import mac as mac_mod

        self._mac = mac_mod.MacBank(seed, cfg.kx_pubkeys)
        # microsecond wall-clock start via the clock seam (virtual and
        # deterministic under simulation) (Castro-Liskov §2.4: client
        # timestamps are monotonic ACROSS restarts — a counter from 1
        # would leave a restarted client below the replicas' per-client
        # dedup watermark, every request silently dropped as a replay;
        # found by the real-process failover test). Known limitation,
        # shared with every clock-derived request-id scheme: a host clock
        # stepped BACKWARDS across a restart re-enters the replay window
        # until wall-clock passes the old watermark; deploy clients with
        # slewing (not stepping) time sync, or persist the last timestamp.
        self._ts = itertools.count(clock.timestamp_us())
        self._waiters: Dict[int, asyncio.Future] = {}
        # per-ts replies: sender -> (result, superseded, spec). One slot
        # per replica: a replica upgrading
        # its speculative reply to final overwrites its own slot — never
        # a second count toward either quorum — and the stricter (final)
        # mark wins: a late speculative reply never downgrades a
        # recorded final one.
        self._replies: Dict[int, Dict[str, tuple]] = defaultdict(dict)
        # how each accepted ts resolved ("spec" fast path or "final"),
        # consumed by submit() for the latency split benches record
        self._accept_kind: Dict[int, str] = {}
        self._submit_t0: Dict[int, float] = {}
        # speculative answers awaiting final-commit confirmation:
        # ts -> {result, t0, senders}. The fast answer already resolved
        # the submit; f+1 matching FINAL replies upgrade it to confirmed
        # (metrics final_confirms + the confirm-latency sample). Bounded.
        self._confirming: "OrderedDict[int, dict]" = OrderedDict()
        self.CONFIRMING_MAX = 8192
        # (latency_s, "spec"|"final") per accepted request, and the
        # submit->f+1-final confirmation latencies — the bench ledger's
        # p50_spec_latency_ms / p50_final_latency_ms sources
        self.accept_latencies: deque = deque(maxlen=1 << 16)
        self.confirm_latencies: deque = deque(maxlen=1 << 16)
        # wire bytes of in-flight requests, for the mixed-split early
        # rebroadcast below (submit() owns the normal retransmission)
        self._inflight_raw: Dict[int, bytes] = {}
        self._mixed_retry_done: set = set()
        self._bg_tasks: set = set()
        self._task: Optional[asyncio.Task] = None
        self.view_hint = 0  # latest view seen in replies
        # committee-epoch tracking: after a live
        # reconfiguration this client's address book (cfg.replica_ids)
        # is stale — any reply carrying a higher epoch triggers a
        # ConfigFetch round, and f+1 matching signed ConfigReplies from
        # replicas we ALREADY know rebuild the book (one lying replica
        # cannot steer us into a fake committee)
        self._seed = seed
        self.epoch = cfg.epoch
        # sender -> its latest (epoch, config-bytes) claim. Keyed by
        # SENDER, not by claim: each known replica controls exactly one
        # slot, so a hostile replica signing arbitrarily many distinct
        # configs only ever overwrites itself — no eviction policy to
        # game, bounded by the committee size by construction
        self._config_votes: Dict[str, tuple] = {}
        self._config_fetch_at = 0.0
        # sampled request tracing (telemetry.RequestTracer), attached
        # after construction; the client stamps submit/retransmit/
        # accepted so a trace joins the replica-side phases end to end
        self.tracer = None

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._recv_loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _recv_loop(self) -> None:
        while True:
            raw = await self.transport.recv()
            try:
                msg = Message.from_wire(raw)
            except ValueError:
                continue
            if isinstance(msg, ConfigReply):
                self._on_config_reply(msg)
                continue
            if not isinstance(msg, Reply) or msg.client_id != self.id:
                continue
            if msg.sender not in self.cfg.replica_ids:
                continue  # only replicas may answer; f+1 matching assumes it
            fut = self._waiters.get(msg.timestamp)
            confirming = msg.timestamp in self._confirming
            if (fut is None or fut.done()) and not confirming:
                # nobody is waiting on this timestamp (late replies after
                # f+1 matched, or stale retransmissions): skip the
                # signature check — at committee size n the client
                # otherwise pays n-(f+1) wasted verifies per request.
                # (A speculatively-accepted ts awaiting final-commit
                # confirmation still verifies: the f+1 final quorum the
                # confirmation trusts must be signature-checked.)
                continue
            if self.cfg.verify_signatures:
                if msg.mac:
                    # point-to-point fast path: HMAC under the shared key
                    # with the claimed sender (crypto/mac.py)
                    from .crypto import mac as mac_mod

                    key = self._mac.key_for(msg.sender)
                    if key is None or not mac_mod.tag_valid(
                        key, msg.signing_payload(), msg.mac
                    ):
                        continue
                else:
                    pub = self.cfg.pubkey(msg.sender)
                    if pub is None or not msg.sig:
                        continue
                    try:
                        sig = bytes.fromhex(msg.sig)
                    except ValueError:
                        continue
                    # pbftlint: disable=PBL001 -- client-plane loop, not a replica: one-item Ed25519 per reply (~0.1ms native); a to_thread hop per reply would cost more than the verify
                    ok = self.verifier.verify_batch(
                        [
                            BatchItem(
                                pubkey=pub, msg=msg.signing_payload(), sig=sig
                            )
                        ]
                    )
                    if not ok[0]:
                        continue
            if fut is None or fut.done():
                self._on_confirm(msg)
            else:
                self._on_reply(msg)

    def _on_reply(self, msg: Reply) -> None:
        ts = msg.timestamp
        fut = self._waiters.get(ts)
        if fut is None or fut.done():
            return
        self.view_hint = max(self.view_hint, msg.view)
        if msg.epoch > self.epoch:
            # authenticated reply from a later committee epoch: our
            # address book is stale — re-resolve instead of timing out
            # against removed replicas (the reply itself still counts
            # toward f+1 below; epoch is a hint, not part of matching)
            self._maybe_refresh_config(msg.epoch)
        # f+1 matching is on the RESULT only (Castro-Liskov §2.4): honest
        # replicas may execute the same request in different views when a
        # failover re-proposes it, and their replies still agree on the
        # outcome — matching on (result, view) would deadlock exactly
        # when a view change lands mid-request. The view rides along
        # purely as the primary hint above.
        spec = bool(getattr(msg, "spec", 0))
        prev = self._replies[ts].get(msg.sender)
        if prev is not None and not prev[2] and spec:
            # reply accounting: this replica already answered
            # FINAL — a late speculative copy must neither double-count
            # nor downgrade the recorded mark
            return
        self._replies[ts][msg.sender] = (
            msg.result, bool(msg.superseded), spec, msg.seq, msg.view,
        )
        counts_final: Dict[tuple, int] = defaultdict(int)
        counts_slot: Dict[tuple, int] = defaultdict(int)
        for result, superseded, sp, seq, view in self._replies[ts].values():
            counts_slot[(result, superseded, seq, view)] += 1
            if not sp:
                counts_final[(result, superseded)] += 1
        # final answer: f+1 matching non-speculative replies (classic —
        # matching ignores seq/view: honest replicas execute the same
        # request at the same agreed slot, and the result alone is what
        # f+1 vouches for)
        for key, cnt in counts_final.items():
            if cnt >= self.cfg.weak_quorum:
                self._resolve(ts, fut, key, "final")
                return
        # speculative fast answer: 2f+1 matching marks of ANY strength
        # (a final reply subsumes a speculative one from the same
        # replica) — matched on (result, superseded, SEQ, VIEW). The
        # full slot identity is part of the key because the safety
        # argument is per prepare-certificate: 2f+1 speculators of one
        # (view, seq) are 2f+1 preparers of ONE digest there (two
        # conflicting 2f+1 prepare quorums at the same (view, seq) need
        # > f double-voters), and by quorum intersection no later view
        # can install a different block at that seq. Marks for the same
        # request speculated at different seqs — or at the same seq
        # under different views' re-proposals, each with <= f honest
        # preparers — must never pool into a fake quorum.
        for (result, superseded, _seq, _view), cnt in counts_slot.items():
            if cnt >= self.cfg.quorum:
                self._resolve(ts, fut, (result, superseded), "spec")
                return
        # Mixed superseded/real split with no quorum: a checkpoint fold
        # raced our retransmission — replicas that folded answer
        # superseded=1 while laggards re-send the cached real reply, and
        # with designated repliers neither pair may reach f+1 until the
        # fold stabilizes committee-wide (replica._send_superseded has
        # the server-side account). Stabilization needs no help from us,
        # but the answer does: nudge with one early rebroadcast (folded
        # replicas re-answer superseded from durable state) instead of
        # sitting out the full request_timeout.
        flags = {s for _, s, _sp, _seq, _v in self._replies[ts].values()}
        if len(flags) == 2 and ts not in self._mixed_retry_done:
            self._mixed_retry_done.add(ts)
            raw = self._inflight_raw.get(ts)
            if raw is not None:
                loop = asyncio.get_running_loop()
                backoff = min(0.25, self.request_timeout / 4)
                loop.call_later(backoff, self._fire_mixed_retry, ts, raw)

    def _resolve(self, ts: int, fut: asyncio.Future, key: Tuple[str, bool],
                 kind: str) -> None:
        """A quorum formed for ``key`` = (result, superseded): answer the
        waiter. A speculative acceptance additionally keeps collecting
        FINAL replies for the same ts (the final-commit confirmation the
        fast path must retain — satellite/PoE contract)."""
        result, superseded = key
        self._accept_kind[ts] = kind
        if kind == "spec" and not superseded:
            self.metrics["spec_accepted"] += 1
            senders = {
                s
                for s, (res, sup, sp, _seq, _v) in self._replies[ts].items()
                if not sp and (res, sup) == key
            }
            while len(self._confirming) >= self.CONFIRMING_MAX:
                self._confirming.popitem(last=False)
            self._confirming[ts] = {
                "result": result,
                "t0": self._submit_t0.get(ts, clock.now()),
                "senders": senders,
                "contradicting": set(),
            }
        if superseded:
            fut.set_exception(SupersededError())
        else:
            fut.set_result(result)

    def _on_confirm(self, msg: Reply) -> None:
        """A signature-verified reply for a speculatively-accepted ts:
        count FINAL copies toward the f+1 confirmation quorum."""
        ent = self._confirming.get(msg.timestamp)
        if ent is None or getattr(msg, "spec", 0) or msg.superseded:
            return
        if msg.result != ent["result"]:
            # A single contradicting final can be one byzantine replica
            # (well within f) — it must neither fire the alarm nor
            # destroy confirmation tracking. Only f+1 DISTINCT
            # contradictors prove the COMMITTEE contradicted the 2f+1
            # speculative quorum — impossible under quorum intersection
            # unless > f replicas are faulty; surface THAT loudly.
            ent["contradicting"].add(msg.sender)
            if len(ent["contradicting"]) >= self.cfg.weak_quorum:
                self.metrics["spec_final_mismatch"] += 1
                del self._confirming[msg.timestamp]
            return
        ent["senders"].add(msg.sender)
        if len(ent["senders"]) >= self.cfg.weak_quorum:
            self.metrics["final_confirms"] += 1
            self.confirm_latencies.append(clock.now() - ent["t0"])
            del self._confirming[msg.timestamp]

    def _bg(self, coro) -> None:
        """Launch a fire-and-forget send: hold the task reference (GC can
        cancel unreferenced tasks) and consume its exception (a transport
        closed during a backoff must not surface as 'exception was never
        retrieved')."""
        task = asyncio.get_running_loop().create_task(coro)
        self._bg_tasks.add(task)

        def _consume(t: asyncio.Task) -> None:
            self._bg_tasks.discard(t)
            if not t.cancelled():
                t.exception()

        task.add_done_callback(_consume)

    def _fire_mixed_retry(self, ts: int, raw: bytes) -> None:
        if ts not in self._waiters:
            return
        self._bg(self.transport.broadcast(raw, self.cfg.replica_ids))

    # -- committee re-resolution ---------

    def _maybe_refresh_config(self, epoch_hint: int) -> None:
        """Fire one ConfigFetch round at the replicas we still know
        (survivors answer — membership changes are bounded per epoch, so
        f+1 of our current book are members of the new committee).
        Rate-limited: every reply from the new epoch would otherwise
        re-fire the round."""
        now = clock.now()
        if now - self._config_fetch_at < 0.5:
            return
        self._config_fetch_at = now
        self.metrics["config_fetches"] += 1
        cf = ConfigFetch(epoch=epoch_hint)
        self.signer.sign_msg(cf)
        self._bg(self.transport.broadcast(cf.to_wire(), self.cfg.replica_ids))

    def _on_config_reply(self, msg: ConfigReply) -> None:
        """Count signed configuration copies; adopt on f+1 matching
        (epoch, config bytes) from DISTINCT known replicas. Verification
        uses keys we already hold — a reply from an unknown sender (or a
        forged config under a known key) never counts."""
        if msg.sender not in self.cfg.replica_ids or msg.epoch <= self.epoch:
            return
        if self.cfg.verify_signatures:
            pub = self.cfg.pubkey(msg.sender)
            if pub is None or not msg.sig:
                return
            try:
                sig = bytes.fromhex(msg.sig)
            except ValueError:
                return
            # pbftlint: disable=PBL001 -- client-plane loop: one-item Ed25519 per ConfigReply, bounded at one vote slot per known replica (the config-vote table)
            ok = self.verifier.verify_batch(
                [BatchItem(pubkey=pub, msg=msg.signing_payload(), sig=sig)]
            )
            if not ok[0]:
                return
        key = (msg.epoch, msg.config)
        self._config_votes[msg.sender] = key
        if (
            sum(1 for v in self._config_votes.values() if v == key)
            < self.cfg.weak_quorum
        ):
            return
        import json

        try:
            new_cfg = config_from_doc(self.cfg, json.loads(msg.config))
        except ValueError:
            return
        if new_cfg.epoch != msg.epoch:
            return
        self._adopt_config(new_cfg)

    def _adopt_config(self, new_cfg: CommitteeConfig) -> None:
        from .crypto import mac as mac_mod

        self.cfg = new_cfg
        self.epoch = new_cfg.epoch
        self._config_votes.clear()
        # reply MACs key on the replica set: rebuild for the new members
        self._mac = mac_mod.MacBank(self._seed, new_cfg.kx_pubkeys)
        if new_cfg.addrs:
            # socket transports route by peer book — learn the added
            # members' addresses or retransmits to a new primary that
            # joined after our boot book was built silently vanish
            from .transport.base import update_peer_book

            update_peer_book(self.transport, new_cfg.addrs)
        self.metrics["config_refreshes"] += 1
        # chase the new committee NOW: in-flight requests head straight
        # for the new primary instead of waiting out a timeout against a
        # replica that may no longer exist
        primary = self.cfg.primary(self.view_hint)
        resent = 0
        for ts, raw in list(self._inflight_raw.items()):
            if ts in self._waiters:
                self._bg(self.transport.send(primary, raw))
                resent += 1
        if resent:
            self.metrics["config_retransmits"] += resent

    def retries_for_patience(self, patience: float) -> int:
        """Smallest retry count whose CUMULATIVE wait (backoff included,
        jitter ignored) covers ``patience`` seconds. Benches size client
        patience in wall-clock terms ("must outlast a 75 s failover
        stall"); under exponential backoff a fixed retry COUNT would
        silently mean minutes, not the intended budget."""
        total, k = 0.0, 0
        cap = self.backoff_cap if self.backoff_cap > 0 else (
            8.0 * self.request_timeout
        )
        while total < patience and k < 1000:
            total += min(cap, self.request_timeout * (self.backoff_factor ** k))
            k += 1
        return max(1, k - 1)  # k attempts = k-1 retries

    def _attempt_timeout(self, attempt: int) -> float:
        """Wait budget for retry ``attempt`` (0-based): exponential
        backoff from request_timeout, capped, jittered. Monotone in
        expectation — a request never waits LESS than the base timeout
        minus jitter, so the f+1 collection window is never starved."""
        cap = self.backoff_cap if self.backoff_cap > 0 else (
            8.0 * self.request_timeout
        )
        t = min(cap, self.request_timeout * (self.backoff_factor ** attempt))
        if self.jitter > 0:
            t *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return t

    async def submit(self, operation: str, retries: int = 3) -> str:
        """Submit one operation; return the f+1-matched result.

        Retransmissions are IDEMPOTENT by construction: every retry
        re-sends the same signed (client_id, timestamp) request bytes, so
        replicas dedup it server-side (cached-reply resend, never a
        second execution) — a request shed under overload recovers on a
        later attempt instead of becoming a timeout. Retries back off
        exponentially with jitter (see __init__).

        Raises SupersededError if the committee reports the request's
        slot was folded under a checkpoint watermark (the op was not
        applied by this call — see the exception's docstring before
        resubmitting non-idempotent operations)."""
        ts = next(self._ts)
        # completion floor: everything below the oldest still-outstanding
        # submit is answered and will never be retransmitted (see
        # messages.Request.ack — this is what lets replicas fold replay
        # state without NACKing a pipelined sibling still in flight)
        floor = min(self._waiters, default=ts) - 1
        req = Request(
            client_id=self.id, timestamp=ts, operation=operation, ack=floor
        )
        self.signer.sign_msg(req)
        raw = req.to_wire()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiters[ts] = fut
        self._inflight_raw[ts] = raw
        tracer = self.tracer
        rid = tracer.rid_if_sampled(self.id, ts) if tracer is not None else None
        traced = rid is not None
        if traced:
            tracer.emit("submit", rid, op_bytes=len(operation))
        t_sub = clock.now()
        self._submit_t0[ts] = t_sub  # confirmation latency anchors here
        try:
            # first attempt: primary (+ hedged backups); afterwards:
            # broadcast (classic PBFT retransmission — backups forward to
            # the primary and arm view-change timers)
            primary = self.cfg.primary(self.view_hint)
            await self.transport.send(primary, raw)
            ids = self.cfg.replica_ids
            if self.hedge and len(ids) > 1:
                start = ids.index(primary) if primary in ids else 0
                for k in range(self.hedge):
                    # rotate targets per request so hedged load spreads
                    rid = ids[(start + 1 + (ts + k) % (len(ids) - 1)) % len(ids)]
                    if rid != primary:
                        await self.transport.send(rid, raw)
            for attempt in range(retries + 1):
                try:
                    # a SupersededError set on the future raises here
                    result = await asyncio.wait_for(
                        asyncio.shield(fut), self._attempt_timeout(attempt)
                    )
                    if attempt:
                        self.metrics["recovered_after_retry"] += 1
                    kind = self._accept_kind.pop(ts, "final")
                    self.accept_latencies.append(
                        (clock.now() - t_sub, kind)
                    )
                    if traced:
                        tracer.emit("accepted", rid, attempts=attempt + 1)
                    # submit -> f+1 accepted: the client's view of the
                    # whole pipeline — the number every replica-side
                    # span decomposition must add up toward. File lines
                    # only for SAMPLED requests (volume bound).
                    spans.record(
                        spans.CLIENT_E2E,
                        clock.now() - t_sub,
                        node=self.id, rid=rid, persist=traced,
                    )
                    return result
                except asyncio.TimeoutError:
                    if attempt == retries:
                        self.metrics["request_timeouts"] += 1
                        if traced:
                            tracer.emit("timeout", rid, attempts=attempt + 1)
                        raise
                    self.metrics["retransmissions"] += 1
                    if traced:
                        tracer.emit("retransmit", rid, attempts=attempt + 1)
                    await self.transport.broadcast(raw, self.cfg.replica_ids)
            raise asyncio.TimeoutError  # pragma: no cover
        finally:
            self._waiters.pop(ts, None)
            self._replies.pop(ts, None)
            self._inflight_raw.pop(ts, None)
            self._mixed_retry_done.discard(ts)
            self._accept_kind.pop(ts, None)
            self._submit_t0.pop(ts, None)
