"""One-call harness: an N-replica committee + clients on a local network.

The reference's only "deployment" is run.bat launching 4 Windows processes;
this harness is its in-process equivalent and the substrate for every test
and benchmark config in BASELINE.md (4 → 256 replicas).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .app import Application, KVStore
from .client import Client
from .config import CommitteeConfig, KeyPair, make_test_committee
from .consensus.replica import Replica
from .crypto.verifier import Verifier
from .transport.local import FaultPlan, LocalNetwork


@dataclass
class LocalCommittee:
    cfg: CommitteeConfig
    keys: Dict[str, KeyPair]
    net: LocalNetwork
    replicas: List[Replica] = field(default_factory=list)
    clients: List[Client] = field(default_factory=list)
    lag_gauge: Optional[object] = None  # LoopLagGauge (attach_loop_lag)
    traffic_stats: Optional[object] = None  # workload.TrafficStats
    knob_registry: Optional[object] = None  # controller.KnobRegistry

    @staticmethod
    def build(
        n: int = 4,
        clients: int = 1,
        fault_plan: Optional[FaultPlan] = None,
        verifier_factory=None,
        app_factory=KVStore,
        shed_watermark: int = 0,
        max_drain: int = 0,
        ahead_buffer: bool = False,
        **cfg_overrides,
    ) -> "LocalCommittee":
        cfg, keys = make_test_committee(n=n, clients=clients, **cfg_overrides)
        net = LocalNetwork(fault_plan)
        committee = LocalCommittee(cfg=cfg, keys=keys, net=net)
        # shed-plane knobs forward only when set: Replica's defaults are
        # production-sized, and sim scenarios shrink them to make the
        # overload seams reachable at sim scale
        shed_kw = {}
        if shed_watermark:
            shed_kw["shed_watermark"] = shed_watermark
        if max_drain:
            shed_kw["max_drain"] = max_drain
        for rid in cfg.replica_ids:
            committee.replicas.append(
                Replica(
                    node_id=rid,
                    cfg=cfg,
                    seed=keys[rid].seed,
                    transport=net.endpoint(rid),
                    app=app_factory(),
                    verifier=verifier_factory() if verifier_factory else None,
                    ahead_buffer=ahead_buffer,
                    **shed_kw,
                )
            )
        for i in range(clients):
            cid = f"c{i}"
            committee.clients.append(
                Client(
                    client_id=cid,
                    cfg=cfg,
                    seed=keys[cid].seed,
                    transport=net.endpoint(cid),
                )
            )
        return committee

    def start(self) -> None:
        for r in self.replicas:
            r.start()
        for c in self.clients:
            c.start()

    async def stop(self) -> None:
        import asyncio

        if self.lag_gauge is not None:
            await self.lag_gauge.stop()
            self.lag_gauge = None
        # concurrent: graceful stop drains each replica's pipeline (up to
        # ~10 s when certificate-heavy sweeps are mid-flight); serially a
        # 64-node teardown could take minutes. return_exceptions so one
        # failing stop can't abandon the rest mid-teardown
        results = await asyncio.gather(
            *(r.stop() for r in self.replicas), return_exceptions=True
        )
        results += await asyncio.gather(
            *(c.stop() for c in self.clients), return_exceptions=True
        )
        for exc in results:
            if isinstance(exc, BaseException):
                raise exc

    def replica(self, rid: str) -> Replica:
        return next(r for r in self.replicas if r.id == rid)

    # -- telemetry plane (simple_pbft_tpu/telemetry.py) -----------------

    def node_telemetry(self, node_id: str):
        """Unified-telemetry registry for one node of this committee
        (replica or client) — the object StatusServer / FlightRecorder
        serve from."""
        from .telemetry import NodeTelemetry

        for r in self.replicas:
            if r.id == node_id:
                return NodeTelemetry(
                    node_id, replica=r, transport=r.transport,
                    tracer=r.tracer, loop_lag=self.lag_gauge,
                    traffic=self.traffic_stats,
                    knobs=self.knob_registry,
                )
        for c in self.clients:
            if c.id == node_id:
                return NodeTelemetry(
                    node_id, client=c, transport=c.transport,
                    tracer=c.tracer, loop_lag=self.lag_gauge,
                    traffic=self.traffic_stats,
                    knobs=self.knob_registry,
                )
        raise KeyError(node_id)

    def attach_knobs(self):
        """Build the standard knob registry over this committee (the perf
        plane) and surface it in every node's telemetry. Returns
        the registry; a KnobController is attached separately (sim.py
        does both when a scenario asks for the controller)."""
        from .controller import registry_for_committee

        self.knob_registry = registry_for_committee(self)
        return self.knob_registry

    def attach_loop_lag(self, interval: float = 0.1):
        """Start the committee's event-loop lag gauge (one loop
        runs every in-process node, so one gauge serves them all — a
        starved dispatcher core shows in every node's snapshot). Call
        from inside the running loop; stop via ``await
        committee.lag_gauge.stop()`` (committee.stop() does it too)."""
        from .telemetry import LoopLagGauge

        self.lag_gauge = LoopLagGauge(interval=interval)
        self.lag_gauge.start()
        return self.lag_gauge

    def attach_auditors(self, log_dir: Optional[str] = None,
                        watchdog=None) -> Dict[str, object]:
        """Give every replica a SafetyAuditor (the audit plane):
        online safety-invariant checks over the verified message stream,
        with evidence + observation ledgers under ``log_dir`` (None =
        in-memory surfaces only). ``watchdog`` (a ProgressWatchdog)
        makes a safety violation trigger the same forensic dump path as
        a stall. Returns {replica_id: auditor}; close each auditor after
        ``stop()`` to flush the ledgers."""
        from .audit import SafetyAuditor

        auditors: Dict[str, object] = {}
        for r in self.replicas:
            auditors[r.id] = r.auditor = SafetyAuditor(
                r.id, self.cfg, log_dir=log_dir, watchdog=watchdog
            )
        return auditors

    def attach_tracers(self, sample_mod: int = 64, trace_dir: Optional[str] = None):
        """Give every replica AND client a RequestTracer with the same
        deterministic sampling, so a sampled request's lifecycle exists
        at every hop and joins by request id. Returns {node_id: tracer}.
        trace_dir=None keeps events in the in-memory rings only."""
        import os

        from .telemetry import RequestTracer

        tracers = {}
        for node in [*self.replicas, *self.clients]:
            path = (
                os.path.join(trace_dir, f"{node.id}.trace.jsonl")
                if trace_dir
                else None
            )
            tracers[node.id] = node.tracer = RequestTracer(
                node.id, sample_mod=sample_mod, path=path
            )
        return tracers
