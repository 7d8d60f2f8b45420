# pbftlint: deterministic-module
"""Million-user traffic observatory: the open-loop workload plane.

The north star talks about "heavy traffic from millions of users"; every
instrument before this PR only ever watched a handful of closed-loop
test clients. This module is the missing traffic plane: a seeded,
deterministic, OPEN-LOOP arrival process driving 10^5-10^6 *virtual*
clients over the deterministic simulation runtime's virtual clock
(simple_pbft_tpu/sim.py), multiplexed over a BOUNDED pool of real
transport endpoints — never one coroutine (or one object) per client,
so a million-client day fits in one CI job with bounded memory.

Design, in one breath:

- A :class:`WorkloadSpec` names client CLASSES (interactive / bulk /
  byzantine by convention; any names work) with per-class base rates,
  virtual-client populations, read/write mix, payload sizes and hotspot
  skew.
- :class:`ArrivalGen` turns (spec, workload events, seed) into per-
  window aggregate offered counts plus a BOUNDED materialized arrival
  batch — open-loop semantics with a finite load-generator fleet:
  offered demand is accounted exactly (fractional-rate carry
  accumulators, diurnal modulation, burst/remix/flood/storm events),
  while only up to the wire budget is materialized onto the transport
  pool; the overflow is *ingress shed*, counted per class. Virtual-
  client identity is O(1): a hotspot prefix plus a round-robin cold
  pointer give exact distinct-clients-touched accounting with two
  integers per class.
- :class:`TrafficPlane` fires the materialized arrivals in CLUSTERED
  batches at discrete virtual instants (a flash crowd is simultaneous
  arrivals, and under a virtual clock only same-instant traffic can
  queue — smeared arrivals are infinitely-fast-served), drives them
  through the pool clients' ordinary ``submit()`` path, re-enqueues
  timed-out arrivals into the next cluster (synchronized retry waves —
  the correlated-retry-storm shape), and sends byzantine flood frames
  (well-formed requests with garbage signatures in signed committees:
  they reach the verify-admission seam and die as ``bad_sig``;
  undecodable frames in unsigned committees: they die at decode).
- :class:`TrafficStats` keeps per-class cumulative and per-window
  counters plus bounded latency reservoirs, and exposes the ``traffic``
  telemetry block that rides NodeTelemetry snapshots and flight frames
  (pbft_top's LOAD column, tools/traffic_report.py).
- :func:`judge_slo` turns a finished run's stats into machine-checkable
  SLO verdicts beyond safety: bounded p99 per honest class, no starved
  honest class (a FAIRNESS oracle — load-shape invariant, judged
  relative to the best-served class, so honest graceful degradation
  under any offered load passes), and shed-before-collapse (overload
  must surface as shed counters, never as silently queued traffic).

Everything is a pure function of (spec, events, seed): same inputs,
byte-identical arrival stream (:func:`arrival_digest`), byte-identical
sim trace fingerprint. Workload events (burst / remix / retry_storm /
byz_flood) ride FaultSchedule (schema fault-schedule-v3) so one replay
tuple carries faults AND load shape, and sim_explore mutates both.
"""

from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import clock
from .messages import Request

# The authoritative workload-event registry: kind -> one-line
# description. Mirrors faults.KIND_REGISTRY (same drift rule: everything
# naming the kind set derives from this dict). Events target a CLASS
# name (``target``), not a replica id.
WORKLOAD_KIND_REGISTRY: Dict[str, str] = {
    "burst": (
        "flash crowd: multiply the target class's offered rate by "
        "`magnitude` for `duration` seconds ('' targets every honest "
        "class)"
    ),
    "remix": (
        "class remix: move `magnitude` fraction of the source class's "
        "base rate to the destination class for `duration` seconds "
        "(`spec` is 'SRC>DST')"
    ),
    "retry_storm": (
        "correlated retry storm: for `duration` seconds timed-out "
        "arrivals re-enqueue with `magnitude`x the normal attempt "
        "budget, re-fired in synchronized clusters"
    ),
    "byz_flood": (
        "byzantine client flood: the byzantine class offers an EXTRA "
        "`magnitude` x (sum of honest base rates) of bad-signature "
        "requests for `duration` seconds (verify-admission pressure)"
    ),
}

WORKLOAD_KINDS = tuple(WORKLOAD_KIND_REGISTRY)


def workload_kind_table() -> str:
    width = max(len(k) for k in WORKLOAD_KIND_REGISTRY)
    return "\n".join(
        f"- {k.ljust(width)} : {d}" for k, d in WORKLOAD_KIND_REGISTRY.items()
    )


@dataclass(frozen=True)
class WorkloadEvent:
    """One scheduled load-shape change. Field-compatible with
    faults.FaultEvent so schedule mutation/minimization treat fault and
    workload events uniformly; ``target`` names a client CLASS."""

    t: float
    kind: str
    target: str = ""
    duration: float = 0.0
    magnitude: float = 0.0
    spec: str = ""  # remix routing ("bulk>interactive")

    def to_dict(self) -> dict:
        d = {
            "t": round(self.t, 3),
            "kind": self.kind,
            "target": self.target,
            "duration": round(self.duration, 3),
            "magnitude": round(self.magnitude, 4),
        }
        if self.spec:
            d["spec"] = self.spec
        return d


def workload_event_from_dict(e: dict) -> WorkloadEvent:
    kind = e.get("kind", "")
    if kind not in WORKLOAD_KIND_REGISTRY:
        raise ValueError(
            f"cannot replay: unknown workload kind {kind!r} "
            f"(known: {sorted(WORKLOAD_KIND_REGISTRY)}); the schedule was "
            "recorded under a different workload-kind registry"
        )
    return WorkloadEvent(
        t=float(e["t"]),
        kind=kind,
        target=str(e.get("target", "")),
        duration=float(e.get("duration", 0.0)),
        magnitude=float(e.get("magnitude", 0.0)),
        spec=str(e.get("spec", "")),
    )


# ---------------------------------------------------------------------------
# workload specification
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ClientClass:
    """One traffic class: a virtual-client population with a base
    offered rate. ``hot_clients``/``hot_fraction`` give hotspot skew
    (that many low-id clients soak that fraction of arrivals — the
    zipf-head shape without per-client state); ``op_bytes`` pads write
    payloads (bulk traffic is BIG, which is what the planted shed-bias
    defect discriminates on)."""

    name: str
    rate: float            # base offered req/s, plane-wide
    clients: int           # virtual-client population
    read_fraction: float = 0.0
    op_bytes: int = 0
    byzantine: bool = False
    hot_clients: int = 0
    hot_fraction: float = 0.0

    def to_doc(self) -> Dict[str, Any]:
        return {
            "name": self.name, "rate": self.rate, "clients": self.clients,
            "read_fraction": self.read_fraction, "op_bytes": self.op_bytes,
            "byzantine": self.byzantine, "hot_clients": self.hot_clients,
            "hot_fraction": self.hot_fraction,
        }


@dataclass(frozen=True)
class WorkloadSpec:
    """The whole plane's shape. ``pool`` real clients multiplex every
    virtual arrival; ``max_inflight`` bounds concurrently-awaited
    submissions (the plane's memory bound); ``wire_per_window`` bounds
    how many arrivals per accounting window are materialized onto the
    wire (the rest is exact ingress-shed accounting); ``clusters``
    arrivals-per-window instants model simultaneity (see module doc).
    ``shed_watermark`` scales the REPLICA-side shed plane to sim scale
    (0 = the replica default, which a sim-sized committee never
    reaches)."""

    classes: Tuple[ClientClass, ...]
    window: float = 0.5
    pool: int = 4
    max_inflight: int = 512
    wire_per_window: int = 96
    flood_per_window: int = 192
    clusters: int = 2
    diurnal_amplitude: float = 0.0
    diurnal_period: float = 0.0  # 0 = no diurnal modulation
    patience: float = 4.0        # per-arrival end-to-end retry budget (s)
    shed_watermark: int = 0

    def honest(self) -> Tuple[ClientClass, ...]:
        return tuple(c for c in self.classes if not c.byzantine)

    def honest_base_rate(self) -> float:
        return sum(c.rate for c in self.honest())

    def population(self) -> int:
        return sum(c.clients for c in self.classes)

    def to_doc(self) -> Dict[str, Any]:
        return {
            "classes": [c.to_doc() for c in self.classes],
            "window": self.window, "pool": self.pool,
            "max_inflight": self.max_inflight,
            "wire_per_window": self.wire_per_window,
            "flood_per_window": self.flood_per_window,
            "clusters": self.clusters,
            "diurnal_amplitude": self.diurnal_amplitude,
            "diurnal_period": self.diurnal_period,
            "patience": self.patience,
            "shed_watermark": self.shed_watermark,
        }


def spec_from_doc(doc: Dict[str, Any]) -> WorkloadSpec:
    """Rebuild a spec from its JSON form. ``{"preset": name, ...}``
    resolves the named preset first and applies the remaining keys as
    overrides — the compact form Scenario docs and CLI flags use."""
    doc = dict(doc)
    name = doc.pop("preset", None)
    if name is not None:
        base = preset(str(name))
        if not doc:
            return base
        merged = base.to_doc()
        merged.update(doc)
        doc = merged
    classes = tuple(
        ClientClass(
            name=str(c["name"]), rate=float(c["rate"]),
            clients=int(c["clients"]),
            read_fraction=float(c.get("read_fraction", 0.0)),
            op_bytes=int(c.get("op_bytes", 0)),
            byzantine=bool(c.get("byzantine", False)),
            hot_clients=int(c.get("hot_clients", 0)),
            hot_fraction=float(c.get("hot_fraction", 0.0)),
        )
        for c in doc["classes"]
    )
    return WorkloadSpec(
        classes=classes,
        window=float(doc.get("window", 0.5)),
        pool=int(doc.get("pool", 4)),
        max_inflight=int(doc.get("max_inflight", 512)),
        wire_per_window=int(doc.get("wire_per_window", 96)),
        flood_per_window=int(doc.get("flood_per_window", 192)),
        clusters=int(doc.get("clusters", 2)),
        diurnal_amplitude=float(doc.get("diurnal_amplitude", 0.0)),
        diurnal_period=float(doc.get("diurnal_period", 0.0)),
        patience=float(doc.get("patience", 4.0)),
        shed_watermark=int(doc.get("shed_watermark", 0)),
    )


#: Named workload presets (spec_from_doc's {"preset": ...} form, the
#: sim_explore --workload flag, CI jobs). Rates are offered DEMAND —
#: open-loop, independent of what the committee can absorb.
PRESETS: Dict[str, Callable[[], WorkloadSpec]] = {}


def _preset(name: str):
    def reg(fn: Callable[[], WorkloadSpec]):
        PRESETS[name] = fn
        return fn

    return reg


def preset(name: str) -> WorkloadSpec:
    if name not in PRESETS:
        raise ValueError(
            f"unknown workload preset {name!r} (known: {sorted(PRESETS)})"
        )
    return PRESETS[name]()


@_preset("steady")
def _steady() -> WorkloadSpec:
    """Mixed interactive/bulk load a 4-replica sim committee absorbs
    comfortably; the byzantine class idles until a byz_flood event."""
    return WorkloadSpec(
        classes=(
            ClientClass("interactive", rate=60.0, clients=3000,
                        read_fraction=0.5, hot_clients=32,
                        hot_fraction=0.2),
            ClientClass("bulk", rate=20.0, clients=400, op_bytes=96),
            ClientClass("byzantine", rate=0.0, clients=400,
                        byzantine=True),
        ),
        wire_per_window=48, max_inflight=256, shed_watermark=24,
        diurnal_amplitude=0.3, diurnal_period=20.0, patience=4.0,
    )


@_preset("overload")
def _overload() -> WorkloadSpec:
    """Offered demand well past the wire budget: ingress shed is the
    steady state and the replica shed plane engages on every cluster —
    the adversarial exam for the shedding fairness the planted
    shed_bulk_bias defect breaks."""
    return WorkloadSpec(
        classes=(
            ClientClass("interactive", rate=360.0, clients=20000,
                        read_fraction=0.3, hot_clients=64,
                        hot_fraction=0.25),
            ClientClass("bulk", rate=120.0, clients=2500, op_bytes=96),
            ClientClass("byzantine", rate=0.0, clients=2500,
                        byzantine=True),
        ),
        wire_per_window=160, max_inflight=512, shed_watermark=24,
        patience=3.0,
    )


@_preset("smoke1e5")
def _smoke1e5() -> WorkloadSpec:
    """10^5 distinct virtual clients inside a tier-1-sized horizon
    (30 virtual seconds): offered demand covers every population.

    flood_per_window stays BELOW shed_watermark: signed flood frames
    are well-formed, so they compete for overload-shed admission slots
    (the shed plane is deliberately cheaper than verify and runs first)
    and only die later as ``bad_sig``. A cap at/above the watermark
    lets the baseline flood monopolize admission and the "healthy"
    cell measures an attacked committee — byz_flood EVENTS exist to
    push toward the cap on purpose; the baseline must not."""
    return WorkloadSpec(
        classes=(
            ClientClass("interactive", rate=2600.0, clients=70_000,
                        read_fraction=0.4, hot_clients=128,
                        hot_fraction=0.2),
            ClientClass("bulk", rate=950.0, clients=25_000, op_bytes=96),
            ClientClass("byzantine", rate=600.0, clients=15_000,
                        byzantine=True),
        ),
        wire_per_window=64, max_inflight=384, flood_per_window=8,
        shed_watermark=24, patience=3.0,
        diurnal_amplitude=0.25, diurnal_period=15.0,
    )


@_preset("million")
def _million() -> WorkloadSpec:
    """>= 10^6 distinct virtual clients over a ~360 virtual-second day
    (the tier-2 acceptance cell): aggregate offered demand > 10^6 while
    the wire stays bounded — ingress shed carries the difference, the
    honest open-loop-with-finite-fleet semantics."""
    return WorkloadSpec(
        classes=(
            ClientClass("interactive", rate=2400.0, clients=800_000,
                        read_fraction=0.5, hot_clients=512,
                        hot_fraction=0.25),
            ClientClass("bulk", rate=500.0, clients=150_000, op_bytes=128),
            ClientClass("byzantine", rate=250.0, clients=80_000,
                        byzantine=True),
        ),
        wire_per_window=64, max_inflight=384, flood_per_window=8,
        shed_watermark=24, patience=3.0,
        diurnal_amplitude=0.4, diurnal_period=120.0,
    )


@_preset("swing")
def _swing() -> WorkloadSpec:
    """Idle→storm→drain swing (the knob controller's acceptance
    run). The idle baseline is comfortable for the mid shed
    watermark; the storm (a ``swing_events`` burst over the middle
    third) outruns a thin-WAN committee's commit throughput so an
    over-admitting watermark queues past client patience, while an
    over-shedding one pays the synchronized-retry quantum at idle.
    ``op_bytes`` is deliberately heavy: block bytes are what the WAN
    serializes, so admission control has real teeth. Pair with
    ``swing_events(horizon)`` and a ``shape`` fault event (see
    tools/knob_campaign.py)."""
    return WorkloadSpec(
        classes=(
            ClientClass("interactive", rate=60.0, clients=4000,
                        read_fraction=0.4, op_bytes=192,
                        hot_clients=32, hot_fraction=0.2),
            ClientClass("bulk", rate=20.0, clients=600, op_bytes=256),
            ClientClass("byzantine", rate=0.0, clients=400,
                        byzantine=True),
        ),
        wire_per_window=768, max_inflight=2048, clusters=2,
        shed_watermark=64, patience=4.0,
    )


def swing_events(
    horizon: float, magnitude: float = 10.0
) -> Tuple[WorkloadEvent, ...]:
    """The canonical idle→storm→drain event shape over ``horizon``: one
    interactive burst spanning the middle third. The knob campaign and
    the controller-smoke CI job share this single definition so the
    acceptance cell cannot drift between them."""
    return (
        WorkloadEvent(
            t=round(horizon / 3.0, 3), kind="burst", target="interactive",
            duration=round(horizon / 3.0, 3), magnitude=magnitude,
        ),
    )


# ---------------------------------------------------------------------------
# deterministic arrival generation
# ---------------------------------------------------------------------------


@dataclass
class WindowPlan:
    """One accounting window's plan: exact per-class offered/ingress-shed
    counts plus the bounded materialized batch. ``arrivals`` is a list of
    (t_rel, class_name, op) with t_rel relative to plane start."""

    index: int
    t0: float
    offered: Dict[str, int]
    shed_ingress: Dict[str, int]
    arrivals: List[Tuple[float, str, str]]
    floods: int = 0            # materialized bad-auth frames this window
    storm_mult: float = 1.0    # retry-attempt multiplier (retry_storm)


class ArrivalGen:
    """Seeded per-window arrival planner. ``plan(w)`` must be called for
    consecutive windows (internal carry/pointer state); memory is O(
    classes + wire budget), never O(clients)."""

    def __init__(self, spec: WorkloadSpec,
                 events: Sequence[WorkloadEvent], seed: int) -> None:
        self.spec = spec
        self.events = tuple(events)
        self.rng = random.Random((seed << 1) ^ 0x17AFF1C)
        self._carry: Dict[str, float] = {c.name: 0.0 for c in spec.classes}
        self._cold_ptr: Dict[str, int] = {c.name: 0 for c in spec.classes}
        self._cum_hot: Dict[str, int] = {c.name: 0 for c in spec.classes}
        self._cum_cold: Dict[str, int] = {c.name: 0 for c in spec.classes}
        self._flood_carry = 0.0

    # -- demand model ------------------------------------------------------

    def _active(self, t0: float, kind: str) -> List[WorkloadEvent]:
        w = self.spec.window
        return [
            e for e in self.events
            if e.kind == kind and e.t < t0 + w and t0 < e.t + max(e.duration, w)
        ]

    def _rate(self, cls: ClientClass, t0: float) -> float:
        """Offered rate for one class at window start: base rate x
        diurnal x bursts + remix flow. Byzantine classes additionally
        gain byz_flood demand (handled in plan(): flood demand is
        frames, not submissions)."""
        sp = self.spec
        diurnal = 1.0
        if sp.diurnal_period > 0 and sp.diurnal_amplitude:
            diurnal += sp.diurnal_amplitude * math.sin(
                2.0 * math.pi * t0 / sp.diurnal_period
            )
        r = cls.rate * max(0.0, diurnal)
        add = 0.0
        for e in self._active(t0, "burst"):
            if cls.byzantine:
                continue
            if e.target in ("", cls.name):
                r *= max(1.0, e.magnitude)
        for e in self._active(t0, "remix"):
            if ">" not in e.spec:
                continue
            src, dst = e.spec.split(">", 1)
            frac = min(1.0, max(0.0, e.magnitude))
            if cls.name == src:
                r *= (1.0 - frac)
            if cls.name == dst:
                src_cls = next(
                    (c for c in sp.classes if c.name == src), None
                )
                if src_cls is not None:
                    add += frac * src_cls.rate
        return r + add

    def storm_mult(self, t0: float) -> float:
        mults = [max(1.0, e.magnitude)
                 for e in self._active(t0, "retry_storm")]
        return max(mults) if mults else 1.0

    def _flood_rate(self, t0: float) -> float:
        """Extra bad-auth demand (req/s) during byz_flood windows —
        scaled off the honest base rate so a flood means something even
        when the byzantine class's own base rate is zero."""
        base = self.spec.honest_base_rate()
        return sum(
            max(0.0, e.magnitude) * base
            for e in self._active(t0, "byz_flood")
        )

    # -- identity model (O(1) per class) -----------------------------------

    def _client_id(self, cls: ClientClass) -> int:
        """Draw one virtual-client id: hotspot head with probability
        hot_fraction, else the round-robin cold pointer."""
        hot_n = min(cls.hot_clients, cls.clients)
        cold_n = max(1, cls.clients - hot_n)
        if hot_n and self.rng.random() < cls.hot_fraction:
            self._cum_hot[cls.name] += 1
            return self.rng.randrange(hot_n)
        i = self._cold_ptr[cls.name] % cold_n
        self._cold_ptr[cls.name] += 1
        self._cum_cold[cls.name] += 1
        return hot_n + i

    def _account_unmaterialized(self, cls: ClientClass, count: int) -> None:
        """Ingress-shed arrivals still came from clients: advance the
        identity accounting by aggregate (no per-arrival work)."""
        hot_n = min(cls.hot_clients, cls.clients)
        hot = int(round(count * cls.hot_fraction)) if hot_n else 0
        self._cum_hot[cls.name] += hot
        self._cum_cold[cls.name] += count - hot
        self._cold_ptr[cls.name] += count - hot

    def clients_touched(self) -> Dict[str, int]:
        """Exact distinct-clients-touched per class: the hotspot head
        saturates at hot_clients, the cold round-robin saturates at the
        rest of the population."""
        out: Dict[str, int] = {}
        for c in self.spec.classes:
            hot_n = min(c.hot_clients, c.clients)
            cold_n = c.clients - hot_n
            out[c.name] = (
                min(hot_n, self._cum_hot[c.name])
                + min(cold_n, self._cum_cold[c.name])
            )
        return out

    # -- materialization ---------------------------------------------------

    def _op(self, cls: ClientClass, cid: int, w: int) -> str:
        key = f"k_{cls.name[:1]}{cid}"
        if cls.read_fraction and self.rng.random() < cls.read_fraction:
            return f"get {key}"
        pad = "x" * cls.op_bytes
        return f"put {key} v{w}{pad}"

    def plan(self, w: int) -> WindowPlan:
        sp = self.spec
        t0 = w * sp.window
        offered: Dict[str, int] = {}
        shed: Dict[str, int] = {}
        takes: Dict[str, int] = {}
        honest = [c for c in sp.classes if not c.byzantine]
        for c in sp.classes:
            want = self._rate(c, t0) * sp.window + self._carry[c.name]
            n = int(want)
            self._carry[c.name] = want - n
            offered[c.name] = n
        # byz_flood demand rides the byzantine class's offered count
        flood_want = self._flood_rate(t0) * sp.window + self._flood_carry
        flood_extra = int(flood_want)
        self._flood_carry = flood_want - flood_extra
        byz = [c for c in sp.classes if c.byzantine]
        if byz and flood_extra:
            offered[byz[0].name] += flood_extra
        # honest materialization: proportional shares of the wire budget
        total_honest = sum(offered[c.name] for c in honest)
        budget = sp.wire_per_window
        for c in honest:
            n = offered[c.name]
            if total_honest <= budget:
                take = n
            else:
                take = min(n, max(0, int(round(budget * n / total_honest))))
            takes[c.name] = take
            shed[c.name] = n - take
            self._account_unmaterialized(c, n - take)
        # byzantine materialization: flood frames, separately capped
        floods = 0
        for c in byz:
            n = offered[c.name]
            floods = min(n, sp.flood_per_window)
            shed[c.name] = n - floods
            self._account_unmaterialized(c, n - floods)
            break  # one byzantine class per spec by convention
        # proportional weave across classes, clustered into
        # `sp.clusters` simultaneous instants per window (simultaneity
        # is what makes load queue under a virtual clock). The weave
        # order — classes interleaved by fractional position — IS the
        # launch/arrival order within an instant: clean arrival-order
        # shedding at the replica then degrades every class
        # proportionally, which is exactly the fairness property the
        # SLO oracle checks (and the planted shed-bias defect breaks).
        weave: List[Tuple[float, ClientClass]] = []
        for c in honest:
            m = takes.get(c.name, 0)
            weave.extend(((j + 0.5) / m, c) for j in range(m))
        weave.sort(key=lambda x: (x[0], x[1].name))
        k = max(1, sp.clusters)
        buckets: List[List[Tuple[str, str]]] = [[] for _ in range(k)]
        for i, (_, c) in enumerate(weave):
            cid = self._client_id(c)
            buckets[i % k].append((c.name, self._op(c, cid, w)))
        arrivals: List[Tuple[float, str, str]] = []
        for j, batch in enumerate(buckets):
            t = t0 + sp.window * (j + 0.5) / k
            arrivals.extend((t, cls, op) for cls, op in batch)
        return WindowPlan(
            index=w, t0=t0, offered=offered, shed_ingress=shed,
            arrivals=arrivals, floods=floods,
            storm_mult=self.storm_mult(t0),
        )


def arrival_digest(spec: WorkloadSpec, events: Sequence[WorkloadEvent],
                   seed: int, horizon: float) -> str:
    """sha256 over the whole planned arrival stream — the byte-identity
    check the determinism tests assert (same seed => same stream)."""
    gen = ArrivalGen(spec, events, seed)
    h = hashlib.sha256()
    for w in range(int(horizon / spec.window)):
        p = gen.plan(w)
        h.update(repr((
            p.index,
            sorted(p.offered.items()),
            sorted(p.shed_ingress.items()),
            [(round(t, 6), c, op) for t, c, op in p.arrivals],
            p.floods,
            round(p.storm_mult, 4),
        )).encode())
    h.update(repr(sorted(gen.clients_touched().items())).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# traffic accounting
# ---------------------------------------------------------------------------

#: bounded per-class latency reservoir size (deterministic replacement)
LATENCY_RESERVOIR = 4096
#: per-window latency sample cap (windows are short; keep them light)
WINDOW_SAMPLES = 512
#: how many recent windows ride each telemetry snapshot (flight frames
#: at 1 s interval overlap heavily at 0.5 s windows, so the union across
#: frames reconstructs the full timeline — tools/traffic_report.py)
WINDOWS_TAIL = 8


def _percentile(samples: List[float], q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    i = min(len(s) - 1, max(0, int(math.ceil(q * len(s))) - 1))
    return s[i]


class TrafficStats:
    """Per-class cumulative + per-window traffic counters, bounded
    memory. The plane writes; telemetry snapshots and judge_slo read."""

    def __init__(self, spec: WorkloadSpec) -> None:
        self.spec = spec
        self.class_names = [c.name for c in spec.classes]
        self.byz_names = {c.name for c in spec.classes if c.byzantine}
        z = lambda: {n: 0 for n in self.class_names}  # noqa: E731
        self.offered = z()
        self.shed_ingress = z()
        self.wire = z()            # submissions actually fired
        self.accepted = z()
        self.timeouts = z()        # attempts budget exhausted
        self.errors = z()
        self.superseded = z()
        self.requeued = z()        # re-enqueued after a timed-out attempt
        self.abandoned = z()       # in flight past drain, cancelled
        self.floods_sent = 0
        self.clients_touched: Dict[str, int] = z()
        self.peak_inflight = 0
        self.windows: List[Dict[str, Any]] = []
        self._lat: Dict[str, List[float]] = {n: [] for n in self.class_names}
        self._lat_n: Dict[str, int] = {n: 0 for n in self.class_names}
        # end-to-end reservoirs: latency anchored at the
        # request's FIRST launch, carried across plane-owned retries.
        # Per-attempt latency above resets per retry, which makes
        # shedding invisible to p99 — a controller tuned on it would
        # learn to shed everything. E2E is what the knob campaign gates.
        self._e2e: Dict[str, List[float]] = {n: [] for n in self.class_names}
        self._e2e_n: Dict[str, int] = {n: 0 for n in self.class_names}
        self._win_acc: Dict[str, int] = z()
        self._win_lat: Dict[str, List[float]] = {
            n: [] for n in self.class_names
        }

    # -- plane write path --------------------------------------------------

    def note_latency(self, cls: str, latency: float) -> None:
        n = self._lat_n[cls]
        self._lat_n[cls] = n + 1
        res = self._lat[cls]
        if len(res) < LATENCY_RESERVOIR:
            res.append(latency)
        else:
            res[(n * 2654435761) % LATENCY_RESERVOIR] = latency
        win = self._win_lat[cls]
        if len(win) < WINDOW_SAMPLES:
            win.append(latency)

    def note_e2e(self, cls: str, latency: float) -> None:
        n = self._e2e_n[cls]
        self._e2e_n[cls] = n + 1
        res = self._e2e[cls]
        if len(res) < LATENCY_RESERVOIR:
            res.append(latency)
        else:
            res[(n * 2654435761) % LATENCY_RESERVOIR] = latency

    def complete(self, cls: str, outcome: str,
                 latency: float = 0.0) -> None:
        if outcome == "accepted":
            self.accepted[cls] += 1
            self._win_acc[cls] += 1
            self.note_latency(cls, latency)
        else:
            getattr(self, outcome)[cls] += 1  # timeouts/errors/superseded

    def close_window(self, plan: WindowPlan,
                     wire_sent: Dict[str, int]) -> Dict[str, Any]:
        """Seal one window: fold the plan's exact offered/shed counts
        plus the in-window completion accumulators into a window record.
        Completions are attributed to the window they LAND in (the
        timeline a report wants: accepted/s per wall of virtual time)."""
        rec: Dict[str, Any] = {"w": plan.index, "t": round(plan.t0, 3),
                               "classes": {}}
        for n in self.class_names:
            off = plan.offered.get(n, 0)
            sh = plan.shed_ingress.get(n, 0)
            wr = wire_sent.get(n, 0)
            self.offered[n] += off
            self.shed_ingress[n] += sh
            self.wire[n] += wr
            lat = self._win_lat[n]
            rec["classes"][n] = {
                "off": off, "shed": sh, "wire": wr,
                "acc": self._win_acc[n],
                "p50_ms": round(_percentile(lat, 0.50) * 1000, 1),
                "p99_ms": round(_percentile(lat, 0.99) * 1000, 1),
            }
            self._win_acc[n] = 0
            self._win_lat[n] = []
        self.windows.append(rec)
        return rec

    # -- read path ---------------------------------------------------------

    def p99_ms(self, cls: str) -> float:
        return round(_percentile(self._lat[cls], 0.99) * 1000, 1)

    def p50_ms(self, cls: str) -> float:
        return round(_percentile(self._lat[cls], 0.50) * 1000, 1)

    def e2e_p99_ms(self, cls: str) -> float:
        return round(_percentile(self._e2e[cls], 0.99) * 1000, 1)

    def worst_honest_e2e_p99_ms(self) -> float:
        vals = [self.e2e_p99_ms(n) for n in self.class_names
                if n not in self.byz_names and self._e2e[n]]
        return max(vals) if vals else 0.0

    def accept_ratio(self, cls: str) -> float:
        off = self.offered[cls]
        return (self.accepted[cls] / off) if off else 0.0

    def totals(self) -> Dict[str, int]:
        return {
            "offered": sum(self.offered.values()),
            "shed": sum(self.shed_ingress.values()),
            "wire": sum(self.wire.values()),
            "accepted": sum(self.accepted.values()),
            "timeouts": sum(self.timeouts.values()),
            "requeued": sum(self.requeued.values()),
            "clients": sum(self.clients_touched.values()),
            "floods_sent": self.floods_sent,
        }

    def worst_honest_p99_ms(self) -> float:
        vals = [self.p99_ms(n) for n in self.class_names
                if n not in self.byz_names and self._lat[n]]
        return max(vals) if vals else 0.0

    def snapshot_block(self) -> Dict[str, Any]:
        """The ``traffic`` telemetry block (NodeTelemetry snapshots,
        flight frames): cumulative totals, last-closed-window rates, and
        the recent-windows tail traffic_report stitches timelines from.
        Additive to the snapshot schema — SCHEMA_VERSION unchanged, per
        the stability contract in telemetry.py."""
        t = self.totals()
        block: Dict[str, Any] = {
            "schema": 1,
            **t,
            "windows_total": len(self.windows),
            "worst_p99_ms": self.worst_honest_p99_ms(),
            "worst_e2e_p99_ms": self.worst_honest_e2e_p99_ms(),
            "peak_inflight": self.peak_inflight,
            "classes": {},
            "windows_tail": self.windows[-WINDOWS_TAIL:],
        }
        w = self.spec.window
        if self.windows:
            last = self.windows[-1]["classes"]
            block["offered_req_s"] = round(
                sum(c["off"] for c in last.values()) / w, 1
            )
            block["accepted_req_s"] = round(
                sum(c["acc"] for c in last.values()) / w, 1
            )
        for n in self.class_names:
            block["classes"][n] = {
                "offered": self.offered[n],
                "shed": self.shed_ingress[n],
                "wire": self.wire[n],
                "accepted": self.accepted[n],
                "timeouts": self.timeouts[n],
                "requeued": self.requeued[n],
                "clients": self.clients_touched[n],
                "byzantine": n in self.byz_names,
                "p50_ms": self.p50_ms(n),
                "p99_ms": self.p99_ms(n),
                "e2e_p99_ms": self.e2e_p99_ms(n),
                "accept_ratio": round(self.accept_ratio(n), 4),
            }
        return block

    def bench_traffic_block(self, horizon: float) -> Dict[str, Any]:
        """Flat metric block for bench ledger lines (tools/bench_gate.py
        rows under ``traffic.``)."""
        t = self.totals()
        flat: Dict[str, Any] = {
            "offered": t["offered"],
            "accepted": t["accepted"],
            "clients": t["clients"],
            "accepted_req_s": round(t["accepted"] / max(1e-9, horizon), 2),
            "shed_fraction": round(t["shed"] / max(1, t["offered"]), 4),
            "worst_p99_ms": self.worst_honest_p99_ms(),
            "worst_e2e_p99_ms": self.worst_honest_e2e_p99_ms(),
        }
        for n in self.class_names:
            if n in self.byz_names:
                continue
            flat[f"{n}_p99_ms"] = self.p99_ms(n)
            flat[f"{n}_e2e_p99_ms"] = self.e2e_p99_ms(n)
            flat[f"{n}_accept_ratio"] = round(self.accept_ratio(n), 4)
        return flat


# ---------------------------------------------------------------------------
# the traffic plane
# ---------------------------------------------------------------------------


class TrafficPlane:
    """Drives an ArrivalGen's plan over a LocalCommittee's bounded client
    pool on the virtual clock. One task per IN-FLIGHT submission (capped
    at spec.max_inflight), never per client."""

    def __init__(
        self,
        committee,
        spec: WorkloadSpec,
        events: Sequence[WorkloadEvent],
        seed: int,
        horizon: float,
        note: Optional[Callable[..., None]] = None,
    ) -> None:
        import asyncio  # local: keep module import-light for tools

        self._asyncio = asyncio
        self.com = committee
        self.spec = spec
        self.horizon = horizon
        self.gen = ArrivalGen(spec, events, seed)
        self.stats = TrafficStats(spec)
        self.note = note
        self.pool = list(committee.clients)[: spec.pool]
        self._rr = 0
        self._flood_ts = 0
        self._tasks: set = set()
        # (cls, op, attempts_left, born) re-fired at the next cluster
        # instant; ``born`` anchors e2e latency at the FIRST launch so
        # retry waves stay visible in the e2e reservoirs
        self._requeue: List[Tuple[str, str, int, float]] = []
        self._attempts = max(1, int(spec.patience / max(
            0.25, getattr(self.pool[0], "request_timeout", 1.0)
        ))) if self.pool else 1

    # -- submission path ---------------------------------------------------

    def _launch(self, cls: str, op: str, attempts: int,
                win: Dict[str, int], born: float = -1.0) -> None:
        if len(self._tasks) >= self.spec.max_inflight:
            # pool saturated: exact ingress-shed accounting, no wire
            self.stats.shed_ingress[cls] += 1
            return
        win[cls] = win.get(cls, 0) + 1
        c = self.pool[self._rr % len(self.pool)]
        self._rr += 1
        task = self._asyncio.get_running_loop().create_task(
            self._one(c, cls, op, attempts, born)
        )
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        self.stats.peak_inflight = max(
            self.stats.peak_inflight, len(self._tasks)
        )

    async def _one(self, client, cls: str, op: str, attempts: int,
                   born: float = -1.0) -> None:
        from .client import SupersededError

        t0 = clock.now()
        if born < 0:
            born = t0  # first attempt: this launch IS the arrival
        try:
            # single-attempt submits: the PLANE owns retries, re-firing
            # them in synchronized clusters (correlated retry waves) —
            # smeared per-client backoff retries would never queue under
            # a virtual clock (see module doc)
            await client.submit(op, retries=0)
            self.stats.complete(cls, "accepted", clock.now() - t0)
            self.stats.note_e2e(cls, clock.now() - born)
        except self._asyncio.TimeoutError:
            if attempts > 1:
                self.stats.requeued[cls] += 1
                self._requeue.append((cls, op, attempts - 1, born))
            else:
                self.stats.complete(cls, "timeouts")
        except SupersededError:
            self.stats.complete(cls, "superseded")
        except self._asyncio.CancelledError:
            self.stats.abandoned[cls] += 1
            raise
        except Exception:
            self.stats.complete(cls, "errors")

    def _flood_frame(self) -> bytes:
        """One bad-auth frame. Signed committees: a well-formed Request
        from a KNOWN client with a garbage signature — it reaches the
        verify-admission seam and dies as ``bad_sig`` (the per-frame
        verify cost IS the attack). Unsigned committees would EXECUTE a
        well-formed request, so the flood degrades to undecodable bytes
        (killed at decode as ``malformed`` — the only admission seam an
        unsigned deployment has)."""
        self._flood_ts += 1
        c = self.pool[self._flood_ts % len(self.pool)]
        if not self.com.cfg.verify_signatures:
            return b"\xff\xfe" + self._flood_ts.to_bytes(4, "big")
        req = Request(
            client_id=c.id,
            # far-future timestamps: never collide with the pool
            # clients' real submissions (they would be rejected before
            # dedup anyway — bad sig — but collisions would still skew
            # the accounting)
            timestamp=(1 << 60) + self._flood_ts,
            operation="byz", ack=0,
        )
        req.sender = c.id
        req.sig = "00" * 64
        return req.to_wire()

    async def _send_floods(self, count: int) -> None:
        if not count or not self.pool:
            return
        c = self.pool[0]
        primary = c.cfg.primary(c.view_hint)
        for _ in range(count):
            raw = self._flood_frame()
            try:
                await c.transport.send(primary, raw)
            except Exception:
                return
            self.stats.floods_sent += 1

    # -- the run loop ------------------------------------------------------

    async def run(self) -> None:
        sp = self.spec
        t_start = clock.now()
        n_windows = max(1, int(self.horizon / sp.window))
        k = max(1, sp.clusters)
        for w in range(n_windows):
            plan = self.gen.plan(w)
            storm = plan.storm_mult
            wire_sent: Dict[str, int] = {}
            # group arrivals by the plan's cluster instants (PRESERVING
            # the plan's interleaved within-instant order — the replica
            # sheds in arrival order, so launch order is load-bearing
            # for fairness); the requeue list folds into the first
            # cluster (synchronized retry wave)
            att = max(1, int(round(self._attempts * storm)))
            clusters: List[List[Tuple[str, str, int, float]]] = [
                [] for _ in range(k)
            ]
            for t, cls, op in plan.arrivals:
                j = min(k - 1, int((t - plan.t0) / sp.window * k))
                clusters[j].append((cls, op, att, -1.0))
            if self._requeue:
                clusters[0].extend(self._requeue)
                self._requeue = []
            floods_per = plan.floods // k if plan.floods else 0
            for j, batch in enumerate(clusters):
                t_fire = (
                    t_start + plan.t0 + sp.window * (j + 0.5) / k
                )
                dt = t_fire - clock.now()
                if dt > 0:
                    await clock.sleep(dt)
                for cls, op, att, born in batch:
                    self._launch(cls, op, att, wire_sent, born)
                flood_n = (
                    plan.floods - floods_per * (k - 1)
                    if j == k - 1 else floods_per
                )
                await self._send_floods(flood_n)
            # seal the window at its end
            t_end = t_start + (w + 1) * sp.window
            dt = t_end - clock.now()
            if dt > 0:
                await clock.sleep(dt)
            self.stats.clients_touched = self.gen.clients_touched()
            rec = self.stats.close_window(plan, wire_sent)
            if self.note is not None:
                cls_rec = rec["classes"]
                self.note(
                    w=w,
                    off=sum(c["off"] for c in cls_rec.values()),
                    acc=sum(c["acc"] for c in cls_rec.values()),
                    shed=sum(c["shed"] for c in cls_rec.values()),
                    wire=sum(c["wire"] for c in cls_rec.values()),
                )
        # leftover synchronized retries get one final wave
        if self._requeue:
            wire_sent = {}
            for cls, op, att, born in self._requeue:
                self._launch(cls, op, 1, wire_sent, born)
            self._requeue = []
            for n, v in wire_sent.items():
                self.stats.wire[n] += v

    async def drain(self, timeout: float) -> None:
        """Bounded settle for in-flight submissions after the horizon;
        whatever outlives the budget is cancelled and counted
        ``abandoned`` (never silently dropped)."""
        tasks = [t for t in self._tasks if not t.done()]
        if tasks:
            await self._asyncio.wait(tasks, timeout=timeout)
        for t in list(self._tasks):
            if not t.done():
                t.cancel()
        if self._tasks:
            await self._asyncio.gather(
                *list(self._tasks), return_exceptions=True
            )
        self.stats.clients_touched = self.gen.clients_touched()


# ---------------------------------------------------------------------------
# SLO oracles (judged by sim._drive when a scenario carries a workload)
# ---------------------------------------------------------------------------

#: default oracle knobs (Scenario.slo overrides individual keys).
#: Calibrated to be LOAD-SHAPE INVARIANT: a healthy committee shedding
#: gracefully under any offered load passes; only genuine unfairness /
#: unbounded latency / silent queuing fails. See docs/OBSERVABILITY.md.
DEFAULT_SLO: Dict[str, float] = {
    # p99 bound for ACCEPTED requests per honest class; 0 derives
    # (2*patience + 10)s — a structural bound given the plane's bounded
    # attempt budget, so only a latency-accounting or admission bug
    # trips it. Scenarios testing tight SLOs set it explicitly.
    "p99_ms": 0.0,
    # judge a class only past this offered mass (tiny samples lie)
    "min_offered": 50.0,
    # starvation is judged RELATIVELY and PER WINDOW: in one window a
    # class is starved when its accept ratio falls below starve_gap x
    # the best-served honest class's ratio, while that best class is
    # >= fair_floor. Fair arrival-order shedding hands each class
    # budget proportional to its presence in every instant, which
    # EQUALIZES accept ratios within any window — so a healthy
    # committee passes at any overload depth and any load shape, and
    # only genuine class-preferential admission (the shed_bulk_bias
    # shape) fails. Judging per window (not on run totals) matters
    # under fault schedules: the class mix varies across windows while
    # partitions/crashes vary the windows' accept rates, so run-total
    # ratios split apart for healthy committees (Simpson's paradox).
    # Persistence (starve_windows) turns isolated attribution noise —
    # retried requests land in later windows than they were offered —
    # into a non-signal while a real bias starves EVERY loaded window.
    "starve_gap": 0.34,
    "fair_floor": 0.12,
    "starve_windows": 6.0,
    # judge a window's class only past this offered count
    "min_offered_window": 12.0,
    # shed-before-collapse: this many windows that pushed wire traffic,
    # accepted nothing and shed nothing (silent queuing) fail the run.
    # Sized above max_inflight/wire_per_window so a partition window
    # (where the pool legitimately goes blind until the in-flight cap
    # engages) cannot trip it.
    "collapse_windows": 12.0,
}


def judge_slo(
    stats: TrafficStats,
    spec: WorkloadSpec,
    overrides: Optional[Dict[str, float]] = None,
) -> Tuple[Dict[str, Any], Optional[str]]:
    """(verdicts, failure) for one finished run. ``failure`` is a
    ``slo:<detail>`` string for SimResult.failure, or None."""
    cfg = dict(DEFAULT_SLO)
    cfg.update(overrides or {})
    p99_bound = cfg["p99_ms"] or (2.0 * spec.patience + 10.0) * 1000.0
    verdicts: Dict[str, Any] = {"p99": {}, "starvation": {},
                                "shed_before_collapse": {}}
    failure: Optional[str] = None
    honest = [c.name for c in spec.classes if not c.byzantine]

    # bounded p99 per honest class (accepted-request latency)
    for n in honest:
        p99 = stats.p99_ms(n)
        judged = stats.accepted[n] >= 20
        ok = (not judged) or p99 <= p99_bound
        verdicts["p99"][n] = {"p99_ms": p99, "bound_ms": round(p99_bound, 1),
                              "judged": judged, "ok": ok}
        if not ok and failure is None:
            failure = f"slo:p99:{n}"

    # no starved honest class (relative fairness, judged per window
    # with persistence — see the DEFAULT_SLO rationale)
    starved_w: Dict[str, int] = {}
    judged_w = 0
    for rec in stats.windows:
        wr = {}
        for n in honest:
            c = rec["classes"].get(n)
            if c and c["off"] >= cfg["min_offered_window"]:
                wr[n] = c["acc"] / c["off"]
        if len(wr) < 2:
            continue
        best = max(wr.values())
        if best < cfg["fair_floor"]:
            continue
        judged_w += 1
        for n, r in wr.items():
            if r < cfg["starve_gap"] * best:
                starved_w[n] = starved_w.get(n, 0) + 1
    starved = sorted(
        n for n, k in starved_w.items() if k >= cfg["starve_windows"]
    )
    ratios = {
        n: stats.accept_ratio(n) for n in honest
        if stats.offered[n] >= cfg["min_offered"]
    }
    verdicts["starvation"] = {
        "ok": not starved, "starved": starved,
        "judged_windows": judged_w,
        "starved_windows": dict(sorted(starved_w.items())),
        "ratios": {n: round(r, 4) for n, r in ratios.items()},
    }
    if starved and failure is None:
        failure = f"slo:starved-class:{','.join(starved)}"

    # shed-before-collapse: overload must surface as shed counters,
    # never as wire traffic that neither completes nor sheds
    blind = best_run = run = 0
    for rec in stats.windows:
        cls = {n: rec["classes"][n] for n in honest if n in rec["classes"]}
        off = sum(c["off"] for c in cls.values())
        acc = sum(c["acc"] for c in cls.values())
        sh = sum(c["shed"] for c in cls.values())
        wire = sum(c["wire"] for c in cls.values())
        if off >= cfg["min_offered"] and wire > 0 and acc == 0 and sh == 0:
            blind += 1
            run += 1
            best_run = max(best_run, run)
        else:
            run = 0
    ok = best_run < cfg["collapse_windows"]
    verdicts["shed_before_collapse"] = {
        "ok": ok, "blind_windows": blind,
        "longest_blind_run": best_run,
        "limit": int(cfg["collapse_windows"]),
    }
    if not ok and failure is None:
        failure = "slo:collapse"
    return verdicts, failure


# ---------------------------------------------------------------------------
# bench-ledger record (tools/bench_gate.py traffic rows)
# ---------------------------------------------------------------------------


def bench_record(
    stats: TrafficStats,
    horizon: float,
    cell: str = "traffic_smoke",
    gate: Optional[Dict[str, Dict[str, float]]] = None,
    gate_mode: str = "",
) -> Dict[str, Any]:
    """One bench ledger line carrying the flat ``traffic`` block
    (schema-pinned like every other ledger line; bench_gate's
    ``traffic.*`` METRICS rows and floors-mode gates read it)."""
    from .telemetry import BENCH_SCHEMA_VERSION

    rec: Dict[str, Any] = {
        "schema_version": BENCH_SCHEMA_VERSION,
        "cell": cell,
        "traffic": stats.bench_traffic_block(horizon),
    }
    if gate:
        rec["gate"] = gate
    if gate_mode:
        rec["gate_mode"] = gate_mode
    return rec


# Regenerate kind documentation from the registry (same no-drift rule as
# faults.KIND_REGISTRY).
__doc__ = (__doc__ or "") + (
    "\n\nWorkload-event kinds (generated from WORKLOAD_KIND_REGISTRY):\n\n"
    + workload_kind_table() + "\n"
)
