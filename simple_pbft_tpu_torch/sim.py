# pbftlint: deterministic-module
"""FoundationDB-style deterministic simulation runtime.

One process, one thread, one committee — and a VIRTUAL clock. The
:class:`SimLoop` is a stock selector event loop whose ``time()`` is a
plain float: when the loop would otherwise sleep until the next
scheduled timer, virtual time JUMPS there instead. A wan3dc scenario
whose shaped links, view-change ladders, statesync retry ticks and
client backoffs burn minutes of wall clock runs in milliseconds, and —
because every product timer either lives on the loop (``call_later`` /
``call_at`` / ``wait_for``) or reads the injectable clock seam
(simple_pbft_tpu_torch/clock.py) — the entire interleaving is a pure function
of the scenario seed. Same seed, same trace, byte for byte.

What runs under simulation is the REAL system: the same Replica /
Client / StateSync / ViewChanger / ShapedTransport / FaultInjector
objects every test and bench uses, over the in-process LocalNetwork.
The only behavioral difference is the clock seam's ``off_thread``,
which runs worker-thread work inline (a real thread completes in wall
time and would race virtual time), and ``qc.verify_qc_async``, which
pairs inline for the same reason.

On top of the runtime, :func:`run_scenario` drives one seeded scenario
end to end — committee up, fault schedule injected at virtual offsets,
paced client load, heal, bounded drain, a liveness probe — and judges
it with machine-checkable oracles:

- **safety**: honest replicas' committed digests must agree per slot,
  and honest auditors must have recorded zero violations unless the
  schedule armed a byzantine injector (docs/AUDIT.md);
- **liveness**: after every fault heals, a fresh request must commit
  within the probe patience (all in virtual time).

``tools/sim_explore.py`` loops the reference package's copy of this
module at thousands of runs per invocation with coverage-guided schedule mutation; :func:`minimize`
delta-debugs a failing schedule's event list down to a minimal
replayable repro (docs/SCENARIOS.md has the workflow).
"""

from __future__ import annotations

import asyncio
import hashlib
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import clock as clock_mod
from .faults import FaultInjector, FaultSchedule, find_shaped

#: virtual-time origin. NOT 0.0: product code uses 0.0 floats as a
#: "never happened" sentinel (last_commit_mono, cooldown maps), and a
#: clock starting at 0 would put the first seconds of a run inside
#: every such sentinel's cooldown window.
SIM_START = 1000.0


class SimStall(RuntimeError):
    """The virtual run wedged: no runnable callbacks, no scheduled
    timers, no I/O — every task is awaiting an event that can never
    arrive. (The discrete-event analogue of a deadlock.)"""


class SimLoop(asyncio.SelectorEventLoop):
    """Selector event loop on virtual time.

    ``BaseEventLoop._run_once`` computes how long it may sleep in
    ``selector.select(timeout)`` from the earliest scheduled timer
    relative to ``self.time()``. We patch both ends of that contract:
    ``time()`` returns the virtual clock, and the selector's ``select``
    never sleeps — it polls real FDs (timeout 0) and, when nothing is
    ready, ADVANCES the virtual clock by the requested timeout. Timers
    become due instantly; runnable callbacks still run in exactly the
    order the real loop would run them.

    A ``select(None)`` request (no ready callbacks, no timers, no I/O)
    gets a bounded number of short REAL waits — a stray worker thread
    may still wake the loop via ``call_soon_threadsafe`` — and then
    raises :class:`SimStall`, because in a deterministic run it means
    the simulation can never progress again.
    """

    #: bounded real waits (MAX_IDLE_SPINS * IDLE_SPIN_S wall seconds)
    #: before an idle loop with nothing scheduled is declared wedged
    MAX_IDLE_SPINS = 200
    IDLE_SPIN_S = 0.02

    def __init__(self, start: float = SIM_START) -> None:
        super().__init__()
        self._sim_now = float(start)
        self._idle_spins = 0
        inner_select = self._selector.select

        def _sim_select(timeout: Optional[float] = None):
            events = inner_select(0)
            if events:
                self._idle_spins = 0
                return events
            if timeout:
                # the loop wanted to sleep until its next timer: jump
                self._sim_now += timeout
                self._idle_spins = 0
                return events
            if timeout == 0:
                return events
            self._idle_spins += 1
            if self._idle_spins > self.MAX_IDLE_SPINS:
                raise SimStall(
                    "no runnable callbacks, no scheduled timers, no "
                    "I/O: the virtual run can never progress (a task "
                    "awaits an event nothing will deliver)"
                )
            return inner_select(self.IDLE_SPIN_S)

        self._selector.select = _sim_select  # type: ignore[method-assign]

    def time(self) -> float:
        return self._sim_now


def _cancel_all_tasks(loop: asyncio.AbstractEventLoop) -> None:
    tasks = [t for t in asyncio.all_tasks(loop) if not t.done()]
    for t in tasks:
        t.cancel()
    if tasks:
        loop.run_until_complete(
            asyncio.gather(*tasks, return_exceptions=True)
        )
    loop.run_until_complete(loop.shutdown_asyncgens())
    try:
        loop.run_until_complete(loop.shutdown_default_executor())
    except Exception:
        pass  # no executor ever started (the common sim case)


def sim_run(
    main,
    *,
    start: float = SIM_START,
    wall_timeout: float = 300.0,
):
    """Run a coroutine to completion on a fresh :class:`SimLoop` with
    the sim clock installed (and the previous clock restored after —
    nestable under pytest, safe across failures).

    ``wall_timeout`` bounds REAL time: a runaway simulation (infinite
    virtual events) never trips virtual timeouts, so a daemon timer
    cancels the main task from outside and the run fails as
    :class:`SimStall` instead of hanging CI.
    """
    loop = SimLoop(start=start)
    prev_clock = clock_mod.install(clock_mod.SimClock(loop))
    asyncio.set_event_loop(loop)
    fired: List[bool] = []
    timer: Optional[threading.Timer] = None
    try:
        task = loop.create_task(main)
        if wall_timeout:
            def _expire() -> None:
                fired.append(True)
                loop.call_soon_threadsafe(task.cancel)

            timer = threading.Timer(wall_timeout, _expire)
            timer.daemon = True
            timer.start()
        try:
            return loop.run_until_complete(task)
        except asyncio.CancelledError:
            if fired:
                raise SimStall(
                    f"wall timeout {wall_timeout}s exceeded — the "
                    "simulation was cancelled from outside virtual time"
                ) from None
            raise
    finally:
        if timer is not None:
            timer.cancel()
        try:
            _cancel_all_tasks(loop)
        finally:
            clock_mod.install(prev_clock)
            asyncio.set_event_loop(None)
            loop.close()


# ---------------------------------------------------------------------------
# deterministic event trace
# ---------------------------------------------------------------------------


class SimTrace:
    """Append-only deterministic event log. Every line is a pure
    function of the scenario seed (virtual timestamps, protocol
    content); the sha256 fingerprint is the replay-identity check the
    acceptance criteria require (same seed => byte-identical trace)."""

    def __init__(self, loop: asyncio.AbstractEventLoop,
                 base: float = SIM_START) -> None:
        self._loop = loop
        self._base = base
        self.lines: List[str] = []

    def note(self, tag: str, **kv: Any) -> None:
        t = self._loop.time() - self._base
        fields = " ".join(f"{k}={kv[k]}" for k in sorted(kv))
        self.lines.append(f"{t:.6f} {tag} {fields}")

    def fingerprint(self) -> str:
        h = hashlib.sha256()
        for line in self.lines:
            h.update(line.encode())
            h.update(b"\n")
        return h.hexdigest()


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


@dataclass
class Scenario:
    """One seeded simulation scenario: committee shape, load, fault
    schedule, oracles' knobs. Everything is deterministic given the
    fields — a Scenario (plus its resolved schedule) IS the repro."""

    seed: int = 1
    n: int = 4
    clients: int = 1
    requests: int = 8          # per client, paced across the horizon
    horizon: float = 10.0      # virtual seconds of scheduled faulting
    drain: float = 60.0        # virtual ceiling for post-heal settling
    # Virtual budget per liveness probe. Calibrated ABOVE the view-change
    # backoff ladder's worst post-storm convergence: the ladder caps at
    # 60 s/replica, and a crashed TARGET-view primary costs two
    # backed-off expiries to walk past — measured recoveries at ~+70 s
    # (seed-10012: lossy storm + crash) and ~+115 s (search repro:
    # crash + late outbound cut; the committee sat at target 4 whose
    # primary was the crashed r0) — see the docs/SCENARIOS.md triage.
    # The oracle hunts WEDGES, not slow-but-converging failover tails;
    # convergence SPEED is a coverage signal (probe_s) instead. The
    # tail DEPTH scales with storm depth (deeper targets + 60 s-capped
    # desynchronized backoffs: measured +369 s on the checked-in
    # crash+cut repro, +750 s on a deeper double-symmetric-cut one), so
    # no fixed patience separates "slow" from "never" in every family —
    # 600 s covers the sweep/smoke families, deeper-storm search
    # families may legitimately surface beyond-patience tails as
    # findings for triage (docs/SCENARIOS.md), and a true wedge fails
    # at ANY patience.
    probe_patience: float = 600.0
    # schedule sources, in precedence order:
    schedule: Optional[FaultSchedule] = None  # explicit (replay/minimize)
    spec: str = ""             # --fault-schedule grammar
    gen: Dict[str, Any] = field(default_factory=dict)  # generate() kwargs
    qc_mode: bool = False
    verify_signatures: bool = True
    # speculative execution. Repro artifacts recorded BEFORE
    # the feature carry {"speculative": false} so they replay the exact
    # interleaving that was minimized (speculative reply traffic shifts
    # every downstream virtual timestamp); new scenarios default on.
    speculative: bool = True
    view_timeout: float = 1.0
    checkpoint_interval: int = 16
    watermark_window: int = 256
    request_timeout: float = 1.0
    probes: int = 2  # sequential post-heal liveness probes (ALL must land)
    defects: Tuple[str, ...] = ()  # planted-defect knobs (statesync.DEFECTS)
    audit_dir: Optional[str] = None  # write auditor ledgers here
    # open-loop traffic plane: a WorkloadSpec doc — usually
    # the compact {"preset": name, ...overrides} form. When set, the
    # plane REPLACES the closed-loop pumps (sc.clients/requests are
    # ignored; the committee gets spec.pool clients), workload events
    # ride the resolved FaultSchedule (schema v3), and the SLO oracles
    # in judge_slo() run after the safety/liveness oracles.
    workload: Optional[Dict[str, Any]] = None
    slo: Dict[str, Any] = field(default_factory=dict)  # judge_slo overrides
    flight_dir: Optional[str] = None  # write per-replica flight frames here
    # cross-replica trace plane: when set, wire stamping is
    # enabled for the run and the process-wide span recorder writes its
    # ledger (spans + cross-node edge docs + quorum docs) to
    # <trace_dir>/sim.spans.jsonl. Virtual-clock timestamps make the
    # joined ledger byte-deterministic across identical seeds. None =
    # off: scenarios recorded before the trace plane replay with
    # identical fingerprints
    # (the envelope changes wire byte counts the SimTrace hashes).
    trace_dir: Optional[str] = None
    # self-driving perf plane. ``knobs``: fixed settings
    # {knob name -> ladder value} applied through the KnobRegistry after
    # build (the campaign's fixed-knob cells). ``controller``: online
    # KnobController config ({interval, profile, cooldown_ticks,
    # effect_ticks, osc_window_ticks, freeze_ticks, ledger}); None = off
    # — scenarios recorded before the perf plane replay with identical
    # fingerprints.
    knobs: Dict[str, Any] = field(default_factory=dict)
    controller: Optional[Dict[str, Any]] = None
    name: str = ""

    def replica_ids(self) -> Tuple[str, ...]:
        return tuple(f"r{i}" for i in range(self.n))

    def workload_spec(self):
        """Resolved WorkloadSpec, or None for closed-loop scenarios."""
        if not self.workload:
            return None
        from .workload import spec_from_doc

        return spec_from_doc(self.workload)

    def resolved_schedule(self) -> FaultSchedule:
        if self.schedule is not None:
            return self.schedule
        ids = self.replica_ids()
        if self.spec:
            return FaultSchedule.parse(self.spec, self.horizon, ids)
        gen = dict(self.gen)
        wspec = self.workload_spec()
        if wspec is not None and "class_names" not in gen:
            # give generated burst/remix events real classes to target
            gen["class_names"] = tuple(c.name for c in wspec.honest())
        return FaultSchedule.generate(
            seed=self.seed, horizon=self.horizon, replica_ids=ids,
            **gen,
        )

    def to_doc(self) -> Dict[str, Any]:
        """JSON form for repro artifacts. The schedule rides RESOLVED
        (explicit event list), so the artifact replays the exact events
        even if generate()'s dealing ever changes."""
        return {
            "seed": self.seed,
            "n": self.n,
            "clients": self.clients,
            "requests": self.requests,
            "horizon": self.horizon,
            "drain": self.drain,
            "probe_patience": self.probe_patience,
            "schedule": self.resolved_schedule().summary(),
            "qc_mode": self.qc_mode,
            "verify_signatures": self.verify_signatures,
            "speculative": self.speculative,
            "view_timeout": self.view_timeout,
            "checkpoint_interval": self.checkpoint_interval,
            "watermark_window": self.watermark_window,
            "request_timeout": self.request_timeout,
            "probes": self.probes,
            "defects": list(self.defects),
            "workload": self.workload,
            "slo": dict(self.slo),
            "knobs": dict(self.knobs),
            "controller": self.controller,
            "trace_dir": self.trace_dir,
            "name": self.name,
        }

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "Scenario":
        return cls(
            seed=int(doc.get("seed", 1)),
            n=int(doc.get("n", 4)),
            clients=int(doc.get("clients", 1)),
            requests=int(doc.get("requests", 8)),
            horizon=float(doc.get("horizon", 10.0)),
            drain=float(doc.get("drain", 60.0)),
            probe_patience=float(doc.get("probe_patience", 600.0)),
            schedule=FaultSchedule.from_summary(doc["schedule"]),
            qc_mode=bool(doc.get("qc_mode", False)),
            verify_signatures=bool(doc.get("verify_signatures", True)),
            speculative=bool(doc.get("speculative", True)),
            view_timeout=float(doc.get("view_timeout", 1.0)),
            checkpoint_interval=int(doc.get("checkpoint_interval", 16)),
            watermark_window=int(doc.get("watermark_window", 256)),
            request_timeout=float(doc.get("request_timeout", 1.0)),
            probes=int(doc.get("probes", 2)),
            defects=tuple(doc.get("defects", ())),
            workload=doc.get("workload") or None,
            slo=dict(doc.get("slo", {})),
            knobs=dict(doc.get("knobs", {})),
            controller=doc.get("controller") or None,
            trace_dir=doc.get("trace_dir") or None,
            name=str(doc.get("name", "")),
        )


@dataclass
class SimResult:
    ok: bool
    failure: Optional[str]  # "<class>:<detail>" or None
    coverage: Dict[str, int]
    fingerprint: str
    committed: int
    wall_s: float
    vtime_s: float
    schedule: Dict[str, Any]  # FaultSchedule.summary() — replayable
    byzantine: List[str]
    app_digests: Dict[str, str]
    details: Dict[str, Any] = field(default_factory=dict)

    @property
    def failure_class(self) -> Optional[str]:
        return self.failure.split(":", 1)[0] if self.failure else None


def coverage_key(cov: Dict[str, int]) -> Tuple[int, ...]:
    """Bucketed coverage signature for novelty search. Coarse on
    purpose: the corpus should grow on qualitatively new interleavings
    (a view change happened at all; statesync aborted at all), not on
    every commit-count wiggle."""

    def bucket(x: int) -> int:
        for i, edge in enumerate((0, 2, 8, 32)):
            if x <= edge:
                return i
        return 4

    return (
        min(int(cov.get("max_view", 0)), 4),
        bucket(int(cov.get("commits", 0))),
        bucket(int(cov.get("vc_started", 0))),
        int(cov.get("statesync", 0) > 0),
        int(cov.get("statesync_restarts", 0) > 0),
        int(cov.get("statesync_abandoned", 0) > 0),
        # starvation ramp: 0 none, 1 <=3 ticks, 2 <=15, 3 <=63, 4 = at
        # the abandon cliff
        next((i for i, edge in enumerate((0, 3, 15, 63))
              if int(cov.get("statesync_stall_ticks", 0)) <= edge), 4),
        int(cov.get("violations", 0) > 0),
        min(int(cov.get("epoch", 0)), 2),
        bucket(int(cov.get("checkpoints", 0))),
        int(cov.get("timeouts", 0) > 0),
        # recovery-latency bucket: 0 <=5s, 1 <=30s, 2 <=90s, 3 <=240s,
        # 4 beyond (the near-wedge tail the search should dwell in)
        next((i for i, edge in enumerate((5, 30, 90, 240))
              if int(cov.get("probe_s", 0)) <= edge), 4),
        # speculative plane: did anything speculate, and did
        # a ROLLBACK fire — the ramp the search climbs toward
        # rollback-during-reconfig-during-view-change interleavings
        int(cov.get("spec_executed", 0) > 0),
        bucket(int(cov.get("spec_rolled_back", 0))),
        # traffic plane: load-shape search climbs per-class
        # shed/latency gradients, not just protocol-state novelty. All
        # keys absent on closed-loop runs (cov.get -> 0: legacy corpus
        # signatures extend with zeros, they don't change meaning).
        int(cov.get("offered", 0) > 0),
        # total shed percent ramp (ingress + replica-plane)
        next((i for i, edge in enumerate((0, 5, 20, 60))
              if int(cov.get("shed_pct", 0)) <= edge), 4),
        # worst honest-class p99 ramp (ms): the latency-tail gradient
        next((i for i, edge in enumerate((50, 250, 1000, 4000))
              if int(cov.get("worst_p99_ms", 0)) <= edge), 4),
        # fairness spread: worst honest accept-ratio percent vs best —
        # the starvation GRADIENT (the planted shed-bias defect lives
        # at the far end)
        next((i for i, edge in enumerate((5, 20, 50, 80))
              if int(cov.get("fair_gap_pct", 0)) <= edge), 4),
        bucket(int(cov.get("requeued", 0)) // 8),
        int(cov.get("floods_sent", 0) > 0),
    )


# ---------------------------------------------------------------------------
# the scenario driver
# ---------------------------------------------------------------------------


def _heal_everything(com) -> None:
    """Close every network fault so the drain phase judges the
    PROTOCOL's recovery, not a still-degraded network. Byzantine
    wrappers deliberately persist — a byzantine replica does not heal,
    and the committee must survive it regardless."""
    for r in com.replicas:
        shaped = find_shaped(r.transport)
        if shaped is not None:
            shaped.heal()
            shaped.clear_shaping()
    com.net.faults.partitions.clear()
    com.net.faults.drop_rate = 0.0
    com.net.faults.delay_range = (0.0, 0.0)


async def _pump(client, sc: Scenario, idx: int, stats: Dict[str, int]) -> None:
    """Paced client load: requests spread across the horizon so fault
    windows land on in-flight traffic. Mid-fault timeouts are expected
    (liveness is judged by the post-heal probe, not by the storm)."""
    gap = sc.horizon / max(1, sc.requests)
    retries = client.retries_for_patience(min(sc.horizon, 8.0))
    for i in range(sc.requests):
        try:
            await client.submit(f"put k{idx}_{i} v{i}", retries=retries)
            stats["accepted"] += 1
        except asyncio.TimeoutError:
            stats["timeouts"] += 1
        except Exception:
            stats["errors"] += 1
        await clock_mod.sleep(gap)


async def _drive(sc: Scenario, trace: SimTrace) -> SimResult:
    from .committee import LocalCommittee
    from .consensus import replica as replica_mod
    from .consensus import speculation as speculation_mod
    from .consensus import statesync as statesync_mod
    from . import spans as spans_mod
    from . import trace as trace_plane

    t0_wall = time.monotonic()
    loop = asyncio.get_running_loop()
    wspec = sc.workload_spec()
    build_extra: Dict[str, Any] = {}
    if wspec is not None and wspec.shed_watermark:
        # scale the replica shed plane to sim scale — the production
        # default watermark is sized for real deployments and a
        # sim-sized committee would never reach it, leaving the
        # overload/fairness seams unexercised
        build_extra["shed_watermark"] = wspec.shed_watermark
    com = LocalCommittee.build(
        n=sc.n,
        # the traffic plane multiplexes every virtual client over a
        # BOUNDED pool of real endpoints; closed-loop scenarios keep
        # their per-client pumps
        clients=wspec.pool if wspec is not None else sc.clients,
        qc_mode=sc.qc_mode,
        verify_signatures=sc.verify_signatures,
        view_timeout=sc.view_timeout,
        checkpoint_interval=sc.checkpoint_interval,
        watermark_window=sc.watermark_window,
        speculative=sc.speculative,
        **build_extra,
    )

    def _tap(src: str, dst: str, kind: str, nbytes: int, verdict: str) -> None:
        trace.note("net", s=src, d=dst, k=kind, n=nbytes, v=verdict)

    com.net.trace = _tap
    if sc.trace_dir:
        # cross-replica trace plane: stamp hot consensus wire
        # frames and route the process-wide span recorder (phase spans +
        # cross-node edge docs + per-cert quorum docs) into one joined
        # ledger. Enabled BEFORE any traffic flows; restored in finally
        # so back-to-back runs in one process stay independent (the
        # configure() calls also reset the per-sender span counters that
        # make two identical seeded runs byte-identical).
        trace_plane.configure(True)
        spans_mod.configure("sim", f"{sc.trace_dir}/sim.spans.jsonl")
    auditors: Dict[str, Any] = {}
    if sc.verify_signatures:
        # the audit plane taps the signature-VERIFIED stream; unsigned
        # committees have no proof-grade stream to observe
        auditors = com.attach_auditors(log_dir=sc.audit_dir)
    prev_defects = set(statesync_mod.DEFECTS)
    statesync_mod.DEFECTS |= set(sc.defects)
    # planted-defect registries are per-module; the scenario's defect
    # list feeds them all (unknown names are simply inert in each)
    prev_spec_defects = set(speculation_mod.DEFECTS)
    speculation_mod.DEFECTS |= set(sc.defects)
    prev_replica_defects = set(replica_mod.DEFECTS)
    replica_mod.DEFECTS |= set(sc.defects)
    schedule = sc.resolved_schedule()
    injector = FaultInjector(committee=com, schedule=schedule)
    failure: Optional[str] = None
    pump_stats: Dict[str, int] = {"accepted": 0, "timeouts": 0, "errors": 0}
    plane = None
    flight_recorders: List[Any] = []
    if wspec is not None:
        from .workload import TrafficPlane

        plane = TrafficPlane(
            com, wspec, schedule.workload, sc.seed, sc.horizon,
            # per-window load notes ride the trace, so the run
            # fingerprint covers the traffic timeline too
            note=lambda **kv: trace.note("load", **kv),
        )
        com.traffic_stats = plane.stats
    controller = None
    registry = None
    knob_baseline: Dict[str, Any] = {}
    final_knobs: Dict[str, Any] = {}
    if sc.knobs or sc.controller is not None:
        # perf plane: fixed knob cells go through the same
        # bounds-enforcing registry the online controller uses — an
        # off-ladder campaign cell fails loudly here, not silently
        registry = com.attach_knobs()
        # some knob targets are process-global (the QC verify lane is a
        # singleton) — snapshot before touching so this run's tuning
        # can't leak into the next run_scenario in the same process
        knob_baseline = registry.values()
        for kname in sorted(sc.knobs):
            registry.set(kname, sc.knobs[kname])
    try:
        com.start()
        if sc.controller is not None:
            from .controller import KnobController

            cdoc = dict(sc.controller)
            ledger_path = cdoc.pop("ledger", None)
            if ledger_path is None and sc.flight_dir:
                ledger_path = (
                    f"{sc.flight_dir}/{sc.name or 'sim'}.knobs.jsonl"
                )
            # the controller watches the PRIMARY's snapshot: traffic/
            # qc/knob blocks are committee-wide and the primary owns the
            # backlog the admission rules react to
            tel = com.node_telemetry(com.replicas[0].id)
            controller = KnobController(
                registry, tel.snapshot, ledger_path,
                interval=float(cdoc.pop("interval", 0.5)),
                profile=str(cdoc.pop("profile", "default")),
                cooldown_ticks=int(cdoc.pop("cooldown_ticks", 2)),
                effect_ticks=int(cdoc.pop("effect_ticks", 2)),
                osc_window_ticks=int(cdoc.pop("osc_window_ticks", 6)),
                freeze_ticks=int(cdoc.pop("freeze_ticks", 8)),
            )
            controller.start()
        for c in com.clients:
            c.request_timeout = sc.request_timeout
        if sc.flight_dir:
            from .telemetry import FlightRecorder

            for r in com.replicas:
                fr = FlightRecorder(
                    com.node_telemetry(r.id),
                    f"{sc.flight_dir}/flight_{r.id}.jsonl",
                )
                fr.start()
                flight_recorders.append(fr)
        inj_task = loop.create_task(
            injector.run(stop_at=clock_mod.now() + sc.horizon)
        )
        if plane is not None:
            pumps = [loop.create_task(plane.run())]
        else:
            pumps = [
                loop.create_task(_pump(c, sc, i, pump_stats))
                for i, c in enumerate(com.clients)
            ]
        await clock_mod.sleep(sc.horizon)
        injector.stop()
        await asyncio.gather(inj_task, return_exceptions=True)
        _heal_everything(com)
        trace.note("healed")
        # bounded drain: let in-flight pumps finish or give up
        done, pending = await asyncio.wait(pumps, timeout=sc.drain)
        for p in pending:
            p.cancel()
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)
        if plane is not None:
            # settle the plane's in-flight submissions (whatever
            # outlives the budget is counted abandoned, never lost)
            await plane.drain(sc.drain)
            pump_stats["accepted"] += sum(plane.stats.accepted.values())
            pump_stats["timeouts"] += sum(plane.stats.timeouts.values())
            pump_stats["errors"] += sum(plane.stats.errors.values())
        # liveness probes: with every network fault healed, a SEQUENCE
        # of fresh requests must commit within the (virtual) probe
        # patience each. A sequence, not one: several wedge shapes (a
        # replica stuck below the stable watermark, a committee one
        # quorum member short of advancing h) stay live for a few more
        # slots and only hit the wall at the watermark window's edge.
        probe = com.clients[0]
        probes_ok = 0
        t_probe0 = clock_mod.now()
        for k in range(sc.probes):
            try:
                await asyncio.wait_for(
                    probe.submit(
                        f"put __probe{k}__ ok",
                        retries=probe.retries_for_patience(sc.probe_patience),
                    ),
                    sc.probe_patience,
                )
                probes_ok += 1
            except asyncio.TimeoutError:
                failure = f"liveness:probe-timeout@{k}"
                break
        trace.note("probes", ok=probes_ok, want=sc.probes)
        pump_stats["probes_ok"] = probes_ok
        pump_stats["probe_s"] = int(clock_mod.now() - t_probe0)
        for fr in flight_recorders:
            await fr.stop()
        flight_recorders = []
        if controller is not None:
            await controller.stop()  # seals the decision ledger
        if sc.trace_dir:
            # seal the quorum ledger: certs still open at shutdown (a
            # straggler vote that never arrived) finalize with what was
            # seen, while the span sink is still attached
            for r in com.replicas:
                r.qstats.flush_all()
        await com.stop()
    finally:
        statesync_mod.DEFECTS.clear()
        statesync_mod.DEFECTS |= prev_defects
        speculation_mod.DEFECTS.clear()
        speculation_mod.DEFECTS |= prev_spec_defects
        replica_mod.DEFECTS.clear()
        replica_mod.DEFECTS |= prev_replica_defects
        for fr in flight_recorders:  # failure path: stop what's left
            try:
                await fr.stop()
            except Exception:
                pass
        if controller is not None and controller._task is not None:
            try:  # failure path: the happy path already stopped it
                await controller.stop()
            except Exception:
                pass
        for a in auditors.values():
            a.close()
        if sc.trace_dir:
            # detach the process-wide surfaces as we found them so the
            # next run_scenario in this process starts untraced
            trace_plane.configure(False)
            spans_mod.configure("", None)
        if registry is not None:
            # read the tuned values for details, then put process-global
            # knob targets (qc lane singleton) back as we found them so
            # back-to-back runs in one process stay seed-deterministic
            final_knobs = registry.values()
            for kname, kval in sorted(knob_baseline.items()):
                try:
                    registry.set(kname, kval)
                except Exception:
                    pass

    # ---- oracles + coverage over the final state ----------------------
    byz = sorted({w.node_id for w in injector.byzantine})
    honest = [r for r in com.replicas if r.id not in byz]
    # safety: per-slot committed-digest agreement across honest replicas
    agreed: Dict[int, str] = {}
    divergent_seq: Optional[int] = None
    for r in honest:
        for seq, digest in r.committed_log.items():
            if seq in agreed and agreed[seq] != digest:
                divergent_seq = seq
            agreed.setdefault(seq, digest)
    if divergent_seq is not None:
        failure = f"safety:commit-divergence@seq{divergent_seq}"
    # speculative-leak oracle: checkpoint digests are a
    # deterministic function of COMMITTED history, identical on every
    # honest replica at the same seq — replicas speculate on different
    # timings, so any leak of speculative state into a checkpoint
    # snapshot diverges the digests instantly. This is the
    # machine-checkable form of "speculative state never leaks into a
    # checkpoint digest".
    cp_by_seq: Dict[int, str] = {}
    cp_divergent: Optional[int] = None
    for r in honest:
        for seq, dg in r.checkpoint_digests.items():
            if seq in cp_by_seq and cp_by_seq[seq] != dg:
                cp_divergent = seq
            cp_by_seq.setdefault(seq, dg)
    if cp_divergent is not None and failure is None:
        failure = f"safety:checkpoint-divergence@seq{cp_divergent}"
    # ...and never into a committed reply: the replicated reply cache is
    # checkpoint state, so a speculative mark inside it would both leak
    # and replay a possibly-rolled-back result to retrying clients
    if failure is None and any(
        getattr(rep, "spec", 0)
        for r in honest
        for per in r.recent_replies.values()
        for rep in per.values()
    ):
        failure = "safety:spec-reply-in-committed-cache"
    violations = sum(
        getattr(auditors.get(r.id), "violations", 0) for r in honest
    )
    if violations and not byz and failure is None:
        failure = "safety:unexpected-evidence"
    # an HONEST replica accused by honest auditors is a safety bug
    # regardless of injected byzantine company: the injectors sign their
    # own lies, so evidence naming anyone else means a replica's
    # replicated state genuinely diverged (the speculative leak shape:
    # speculative state reaching a checkpoint digest shows up exactly
    # here, as checkpoint-divergence evidence among honest nodes)
    accused_union: set = set()
    for r in honest:
        accused_union |= set(
            getattr(auditors.get(r.id), "accused_ever", ()) or ()
        )
    honest_accused = sorted(accused_union - set(byz))
    if honest_accused and failure is None:
        failure = f"safety:honest-accused:{','.join(honest_accused)}"
    # SLO oracles: judged AFTER safety/liveness so a genuine
    # protocol failure keeps its (more actionable) failure class;
    # verdicts ride details.slo either way
    slo_verdicts: Dict[str, Any] = {}
    if plane is not None and wspec is not None:
        from .workload import judge_slo

        slo_verdicts, slo_failure = judge_slo(
            plane.stats, wspec, sc.slo or None
        )
        if slo_failure is not None and failure is None:
            failure = slo_failure
    app_digests = {}
    for r in honest:
        snap = r.app.snapshot()
        app_digests[r.id] = hashlib.sha256(
            repr(sorted(snap.items()) if isinstance(snap, dict) else snap)
            .encode()
        ).hexdigest()[:16]

    cov: Dict[str, int] = {
        "commits": max((r.executed_seq for r in honest), default=0),
        "max_view": max((r.view for r in com.replicas), default=0),
        "views_installed": sum(
            r.metrics.get("views_installed", 0) for r in com.replicas
        ),
        "vc_started": sum(
            r.metrics.get("view_changes_started", 0) for r in com.replicas
        ),
        "statesync": sum(
            r.metrics.get("statesync_transfers", 0) for r in com.replicas
        ),
        "statesync_restarts": sum(
            r.metrics.get("statesync_restarts", 0) for r in com.replicas
        ),
        "statesync_abandoned": sum(
            r.metrics.get("statesync_abandoned", 0) for r in com.replicas
        ),
        # worst consecutive no-progress stretch any transfer saw: the
        # GRADIENT toward starvation interleavings (abandon needs 64
        # ticks; without this ramp the search only sees the cliff)
        "statesync_stall_ticks": max(
            (r.metrics.get("statesync_stall_ticks_max", 0)
             for r in com.replicas), default=0,
        ),
        "checkpoints": max(
            (r.stable_seq for r in com.replicas), default=0
        ) // max(1, sc.checkpoint_interval),
        "violations": violations,
        "epoch": max((r.cfg.epoch for r in com.replicas), default=0),
        "timeouts": pump_stats["timeouts"],
        "accepted": pump_stats["accepted"],
        # post-heal recovery latency (virtual): how long the liveness
        # probes took end to end — the ladder-tail signal (slow failover
        # is COVERAGE to steer toward, not an oracle failure)
        "probe_s": pump_stats.get("probe_s", 0),
        "crashes": injector.crashes_applied,
        "faults_applied": injector.applied_count,
        # speculative plane: slots executed at PREPARED and
        # slots walked back — the rollback count is the novelty signal
        # the schedule search steers toward (rollback-during-reconfig-
        # during-view-change interleavings live behind it)
        "spec_executed": sum(
            r.metrics.get("spec_executed", 0) for r in com.replicas
        ),
        "spec_rolled_back": sum(
            r.metrics.get("spec_rolled_back", 0) for r in com.replicas
        ),
    }
    if plane is not None:
        # traffic-plane coverage: the per-class shed/latency
        # gradients load-shape search climbs. Closed-loop runs carry
        # none of these keys (coverage_key reads them via cov.get).
        stats = plane.stats
        t = stats.totals()
        replica_shed = sum(
            r.metrics.get("messages_shed", 0) for r in com.replicas
        )
        honest_ratios = [
            stats.accept_ratio(n) for n in stats.class_names
            if n not in stats.byz_names and stats.offered[n] >= 50
        ]
        cov.update({
            "offered": t["offered"],
            "ingress_shed": t["shed"],
            "replica_shed": replica_shed,
            "shed_pct": int(
                100 * (t["shed"] + replica_shed) / max(1, t["offered"])
            ),
            "worst_p99_ms": int(stats.worst_honest_p99_ms()),
            "worst_e2e_p99_ms": int(stats.worst_honest_e2e_p99_ms()),
            "fair_gap_pct": int(
                100 * (max(honest_ratios) - min(honest_ratios))
            ) if honest_ratios else 0,
            "requeued": t["requeued"],
            "floods_sent": t["floods_sent"],
            "clients_touched": t["clients"],
        })
    # fold the consensus outcome into the trace so the fingerprint
    # covers protocol RESULTS, not just wire traffic
    for r in sorted(honest, key=lambda x: x.id):
        trace.note(
            "final", id=r.id, exec=r.executed_seq, view=r.view,
            stable=r.stable_seq, app=app_digests[r.id],
        )

    details: Dict[str, Any] = {
        "pump": dict(pump_stats), "trace_lines": len(trace.lines),
    }
    if plane is not None:
        details["traffic"] = plane.stats.snapshot_block()
        # flat block for bench ledger lines (workload.bench_record /
        # tools/traffic_smoke.py — the run itself stays ledger-agnostic)
        details["traffic_bench"] = plane.stats.bench_traffic_block(
            sc.horizon
        )
        details["slo"] = slo_verdicts
    if registry is not None:
        # perf plane: final knob values, controller activity,
        # and the PBL006 invariant (zero post-warm compiles while the
        # controller moved batch-shape knobs) — knob_campaign reads this
        pwc = 0
        for r in com.replicas:
            snap_fn = getattr(getattr(r, "verifier", None), "snapshot", None)
            if callable(snap_fn):
                try:
                    shapes = snap_fn().get("device_shapes") or {}
                    pwc += int(shapes.get("post_warm_compiles", 0) or 0)
                except Exception:
                    pass
        ctl: Dict[str, Any] = {
            "knobs": final_knobs,
            "post_warm_compiles": pwc,
        }
        if controller is not None:
            ctl.update(controller.coverage())
            ctl["ledger"] = (
                controller.ledger.path if controller.ledger else ""
            )
            cov["ctl_actions"] = controller.actions
            cov["ctl_oscillations"] = controller.oscillations
        details["controller"] = ctl
    return SimResult(
        ok=failure is None,
        failure=failure,
        coverage=cov,
        fingerprint=trace.fingerprint(),
        committed=cov["commits"],
        wall_s=round(time.monotonic() - t0_wall, 3),
        vtime_s=round(loop.time() - SIM_START, 3),
        schedule=schedule.summary(),
        byzantine=byz,
        app_digests=app_digests,
        details=details,
    )


def run_scenario(sc: Scenario, *, wall_timeout: float = 120.0) -> SimResult:
    """Run one scenario under the virtual clock; never raises for
    in-scenario failures — the oracle verdict rides SimResult.failure
    (SimStall becomes ``liveness:sim-stall``)."""
    loop_holder: List[SimTrace] = []

    async def main() -> SimResult:
        trace = SimTrace(asyncio.get_running_loop())
        loop_holder.append(trace)
        return await _drive(sc, trace)

    try:
        return sim_run(main(), wall_timeout=wall_timeout)
    except SimStall as e:
        trace = loop_holder[0] if loop_holder else None
        return SimResult(
            ok=False,
            failure="liveness:sim-stall",
            coverage={},
            fingerprint=trace.fingerprint() if trace else "",
            committed=0,
            wall_s=0.0,
            vtime_s=0.0,
            schedule=sc.resolved_schedule().summary(),
            byzantine=[],
            app_digests={},
            details={"stall": str(e)},
        )


# ---------------------------------------------------------------------------
# schedule minimization (delta debugging)
# ---------------------------------------------------------------------------


def minimize(
    sc: Scenario,
    *,
    max_runs: int = 160,
    progress: Optional[Callable[[str], None]] = None,
) -> Tuple[Scenario, SimResult, int]:
    """ddmin over the failing scenario's event list — fault AND workload
    events as one tagged pool (since schema v3 a repro's load shape is
    part of the replay tuple, and a flash crowd can be as load-bearing
    as a crash): find a (locally) minimal subset that still produces the
    SAME failure class, each probe being one full deterministic re-run.
    Returns the minimized scenario (explicit schedule), its result, and
    how many runs the search spent."""
    base_sched = sc.resolved_schedule()
    baseline = run_scenario(replace(sc, schedule=base_sched))
    if baseline.failure is None:
        raise ValueError("minimize() wants a FAILING scenario")
    target = baseline.failure_class
    runs = 1

    def _sched(items: List[Tuple[str, Any]]) -> FaultSchedule:
        return FaultSchedule(
            seed=base_sched.seed,
            horizon=base_sched.horizon,
            events=tuple(e for tag, e in items if tag == "f"),
            workload=tuple(e for tag, e in items if tag == "w"),
        )

    def fails(items: List[Tuple[str, Any]]) -> bool:
        nonlocal runs
        if runs >= max_runs:
            return False
        runs += 1
        res = run_scenario(replace(sc, schedule=_sched(items)))
        return res.failure_class == target

    items: List[Tuple[str, Any]] = (
        [("f", e) for e in base_sched.events]
        + [("w", e) for e in base_sched.workload]
    )
    granularity = 2
    while len(items) >= 2 and runs < max_runs:
        chunk = max(1, len(items) // granularity)
        shrunk = False
        i = 0
        while i < len(items):
            cand = items[:i] + items[i + chunk:]
            if cand and fails(cand):
                items = cand
                granularity = max(2, granularity - 1)
                shrunk = True
                if progress:
                    progress(f"shrunk to {len(items)} events ({runs} runs)")
            else:
                i += chunk
        if not shrunk:
            if granularity >= len(items):
                break
            granularity = min(len(items), granularity * 2)
    # final greedy pass: drop single events
    i = 0
    while i < len(items) and len(items) > 1 and runs < max_runs:
        cand = items[:i] + items[i + 1:]
        if fails(cand):
            items = cand
        else:
            i += 1
    final = replace(sc, schedule=_sched(items))
    return final, run_scenario(final), runs


# ---------------------------------------------------------------------------
# repro artifacts
# ---------------------------------------------------------------------------

ARTIFACT_SCHEMA = "sim-repro-v1"


def artifact_doc(sc: Scenario, result: SimResult) -> Dict[str, Any]:
    return {
        "schema": ARTIFACT_SCHEMA,
        "scenario": sc.to_doc(),
        "failure": result.failure,
        "coverage": result.coverage,
        "fingerprint": result.fingerprint,
        "vtime_s": result.vtime_s,
        "byzantine": result.byzantine,
    }


def scenario_from_artifact(doc: Dict[str, Any]) -> Scenario:
    if doc.get("schema") != ARTIFACT_SCHEMA:
        raise ValueError(
            f"not a {ARTIFACT_SCHEMA} artifact: schema={doc.get('schema')!r}"
        )
    return Scenario.from_doc(doc["scenario"])
