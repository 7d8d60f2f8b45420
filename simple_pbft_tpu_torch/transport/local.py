"""In-process simulated network with fault injection.

The whole committee (replicas + clients) lives in one process, one asyncio
queue per node. This is the test/bench substrate SURVEY.md §4 calls for:
the reference could only be "tested" by launching 4 OS processes and
eyeballing logs; here an N-replica committee is a plain object, and the
network can drop, delay, duplicate, or partition traffic deterministically.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Set, Tuple

from .. import spans, trace
from .base import WireAccounting, base_metrics


@dataclass
class FaultPlan:
    """Deterministic fault injection knobs (seeded RNG)."""

    drop_rate: float = 0.0  # iid drop probability per message
    delay_range: Tuple[float, float] = (0.0, 0.0)  # uniform delay seconds
    duplicate_rate: float = 0.0
    partitions: Set[Tuple[str, str]] = field(default_factory=set)
    # directed (src, dst) pairs that are cut; use both directions for a
    # symmetric partition
    seed: int = 0

    def __post_init__(self) -> None:
        self.rng = random.Random(self.seed)

    def cut(self, src: str, dst: str) -> None:
        self.partitions.add((src, dst))
        self.partitions.add((dst, src))

    def heal(self) -> None:
        self.partitions.clear()


class LocalNetwork:
    """Registry of in-process endpoints + the fault plan."""

    def __init__(self, fault_plan: Optional[FaultPlan] = None) -> None:
        self.queues: Dict[str, asyncio.Queue] = {}
        self.faults = fault_plan or FaultPlan()
        self.delivered = 0
        self.dropped = 0
        # one WireAccounting per node id, shared by every endpoint handle
        # for that node (accounting must survive re-handles) and readable
        # by _deliver for the receiver-side count at enqueue time
        self.wire_accts: Dict[str, WireAccounting] = {}
        # optional delivery tap (the simulation runtime's
        # deterministic event trace): called (src, dst, kind, nbytes,
        # verdict) at every delivery decision. Never allowed to break
        # delivery — exceptions are swallowed at the call sites.
        self.trace = None

    def wire_for(self, node_id: str) -> WireAccounting:
        w = self.wire_accts.get(node_id)
        if w is None:
            w = self.wire_accts[node_id] = WireAccounting(node_id)
        return w

    def endpoint(self, node_id: str) -> "LocalEndpoint":
        if node_id not in self.queues:
            self.queues[node_id] = asyncio.Queue()
        return LocalEndpoint(node_id, self)

    def _trace(self, src: str, dst: str, kind: str, nbytes: int,
               verdict: str) -> None:
        tr = self.trace
        if tr is None:
            return
        try:
            tr(src, dst, kind, nbytes, verdict)
        except Exception:
            # a tracing bug must never break delivery (same contract as
            # the wire-accounting entry points)
            self.trace = None

    async def _deliver(self, src: str, dst: str, raw: bytes) -> None:
        src_wire = self.wire_accts.get(src)
        # classify ONCE per logical send: sender and receiver ledgers
        # must agree on the kind for per-kind conservation to hold
        kind = src_wire.kind_of(raw) if src_wire is not None else ""
        q = self.queues.get(dst)
        if q is None:
            # unknown destination: silently dropped (fire-and-forget)
            if src_wire is not None:
                src_wire.account_lost("no_route", raw)
            self._trace(src, dst, kind, len(raw), "no_route")
            return
        f = self.faults
        if (src, dst) in f.partitions or f.rng.random() < f.drop_rate:
            self.dropped += 1
            # FaultPlan drops are network-side: the sender's ledger owns
            # them (the receiver never saw the frame) — conservation:
            # attempted = sent + lost, and sent == received
            if src_wire is not None:
                src_wire.account_lost("net_dropped", raw)
            self._trace(src, dst, kind, len(raw), "dropped")
            return
        copies = 2 if f.rng.random() < f.duplicate_rate else 1
        lo, hi = f.delay_range
        # messages are stamped at SEND: the receiver's recv span is the
        # full transport residency (injected fault delay + queue wait +
        # receiver scheduling) — the wire's leg of the critical path
        item = (time.perf_counter(), raw)
        dst_wire = self.wire_accts.get(dst)
        self._trace(src, dst, kind, len(raw), "deliver")
        for _ in range(copies):
            delay = f.rng.uniform(lo, hi) if hi > 0 else 0.0
            if delay > 0:
                asyncio.get_running_loop().call_later(delay, q.put_nowait, item)
            else:
                q.put_nowait(item)
            self.delivered += 1
            # accounted at the delivery decision (wire acceptance), not
            # at dequeue: frames resident in the recv queue at a test's
            # end must still reconcile; duplicates count per copy
            if src_wire is not None:
                src_wire.account_send(dst, raw, kind=kind)
            if dst_wire is not None:
                dst_wire.account_recv(raw, kind=kind)


class LocalEndpoint:
    """One node's transport handle on a LocalNetwork."""

    def __init__(self, node_id: str, net: LocalNetwork) -> None:
        self.node_id = node_id
        self.net = net
        self.queue = net.queues[node_id]
        # the FULL shared counter schema (transport.base.COUNTER_SCHEMA):
        # dropped_*/reconnects/frames_* stay zero on a LocalNetwork
        # (drops are network-wide here; see net.dropped) but the keys
        # exist, so the telemetry transport block and pbft_top read every
        # deployment flavor identically
        self.metrics: Dict[str, int] = base_metrics()
        # per-link per-kind msgs+bytes accounting, shared across every
        # endpoint handle for this node id
        self.wire = net.wire_for(node_id)

    async def send(self, dest: str, raw: bytes) -> None:
        self.metrics["sent"] += 1
        await self.net._deliver(self.node_id, dest, raw)

    async def broadcast(self, raw: bytes, dests: Iterable[str]) -> None:
        for dest in dests:
            if dest != self.node_id:
                self.metrics["sent"] += 1
                await self.net._deliver(self.node_id, dest, raw)

    async def recv(self) -> bytes:
        t_sent, raw = await self.queue.get()
        self.metrics["recv"] += 1
        # histogram/ring only (persist=False): one span per message is
        # fine in memory, but must never become a JSONL line per message
        spans.record(
            spans.TRANSPORT_QUEUE,
            time.perf_counter() - t_sent,
            node=self.node_id,
            persist=False,
        )
        # recv-stamp AFTER queue residency so the trace edge's recv time
        # includes injected fault delay and queue wait (never raises; a
        # substring gate makes unstamped frames free)
        trace.recv_stamp(self.node_id, raw)
        return raw

    def recv_nowait(self) -> Optional[bytes]:
        try:
            t_sent, raw = self.queue.get_nowait()
        except asyncio.QueueEmpty:
            return None
        self.metrics["recv"] += 1
        spans.record(
            spans.TRANSPORT_QUEUE,
            time.perf_counter() - t_sent,
            node=self.node_id,
            persist=False,
        )
        trace.recv_stamp(self.node_id, raw)
        return raw
