"""Self-driving perf plane: knob registry + online controller
+ hash-chained decision ledger.

The observatory can attribute every dispatch (devledger/costmodel), gate
every regression (bench_gate), and generate adversarial load at virtual
scale (workload plane) — but the knobs those instruments implicate
(coalesce batch bucket, CPU/device cutoff, QC-lane close window, shed
watermark, speculation depth) were hand-set constructor constants tuned
for one load shape. This module closes the loop:

- :class:`Knob` / :class:`KnobRegistry` lift the scattered constants
  into named, bounded, live-settable knobs. Every knob carries a
  DISCRETE ascending ``choices`` ladder — the controller's whole action
  space. For device-shaped knobs (verify.max_batch, qc.max_batch) the
  ladder is capped at the constructor value, i.e. the ceiling the warmup
  ladder already compiled: moving inside it can never trigger a
  post-warm jit compile (PBL006's zero-recompile contract holds by
  construction, and the campaign gate pins ``post_warm_compiles == 0``).

- :class:`KnobController` runs off the consensus hot path as a clock-
  seam task, reads one telemetry snapshot per tick, distills it into a
  flat signal view, and fires at most ONE rule per tick from the
  priority-ordered :data:`RULES` catalogue (one rule per verdict
  family: traffic admission gap, devledger pad-waste/queue-wait,
  costmodel limiter verdicts, QC-lane pressure, speculation churn).
  Per-knob cooldowns, calm-tick hysteresis (enter fast, exit slow) and
  an oscillation guard (alternating directions inside a short window
  freeze the knob instead of flapping it) keep it from chasing noise.

- :class:`DecisionLedger` appends every decision to a hash-chained
  JSONL file (``<id>.knobs.jsonl``) with the audit plane's chain idiom:
  open → action/guard/effect → close, each record carrying ``prev`` and
  ``h``. An action records the rule fired, the knob's old → new value,
  and the exact trigger signals the rule read — so
  :func:`replay_ledger` can re-derive every action from the ledger
  alone (the replay acceptance test).

Determinism: ticks advance on ``clock.sleep`` and every recorded
timestamp is virtual ``clock.now()`` — under SimClock the same seed
produces a byte-identical ledger (no wall reads anywhere in this
module, enforced by PBL007 via the marker below).
"""
# pbftlint: deterministic-module

from __future__ import annotations

import asyncio
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import clock
from .messages import canonical_json, sha256_hex

log = logging.getLogger("pbft.controller")

#: decision-ledger line schema (schema-stamped like telemetry/bench
#: ledgers; parsers hard-fail on a mismatch rather than misread)
LEDGER_SCHEMA_VERSION = 1

GENESIS = "0" * 64


def chain_hash(rec: Dict[str, Any]) -> str:
    """Hash of a ledger record EXCLUDING its own ``h`` (the audit-plane
    idiom): ``prev`` is inside, so each line commits to the whole
    prefix."""
    body = {k: v for k, v in rec.items() if k != "h"}
    return sha256_hex(canonical_json(body))


# ---------------------------------------------------------------------------
# knob registry
# ---------------------------------------------------------------------------


@dataclass
class Knob:
    """One live-settable performance knob.

    ``choices`` is the FULL action space, ascending: the controller only
    ever steps one rung along it, and ``KnobRegistry.set`` refuses any
    value off the ladder — bounds are enforced at the registry, not by
    each caller's discipline."""

    name: str
    doc: str
    choices: Tuple[Any, ...]
    get: Callable[[], Any]
    set: Callable[[Any], None]
    unit: str = ""


class KnobRegistry:
    """Named, bounded knobs over live subsystems.

    The registry is the single write path for tuning: ``set`` validates
    against the knob's ladder, ``step`` moves one rung and clamps at the
    ends. ``snapshot_block`` is the additive ``knobs`` telemetry block
    (values + bounds + controller posture) that rides NodeTelemetry
    snapshots and flight frames."""

    def __init__(self) -> None:
        self._knobs: Dict[str, Knob] = {}
        #: optional posture source (KnobController.posture) — surfaces
        #: the active profile / last action / guard state in telemetry
        self.posture_source: Optional[Callable[[], Dict[str, Any]]] = None

    def register(self, knob: Knob) -> Knob:
        if not knob.choices:
            raise ValueError(f"knob {knob.name}: empty choices ladder")
        if knob.name in self._knobs:
            raise ValueError(f"knob {knob.name} already registered")
        self._knobs[knob.name] = knob
        return knob

    def names(self) -> List[str]:
        return sorted(self._knobs)

    def __contains__(self, name: str) -> bool:
        return name in self._knobs

    def knob(self, name: str) -> Knob:
        return self._knobs[name]

    def value(self, name: str) -> Any:
        return self._knobs[name].get()

    def values(self) -> Dict[str, Any]:
        return {n: self._knobs[n].get() for n in self.names()}

    def set(self, name: str, value: Any) -> None:
        k = self._knobs[name]
        if value not in k.choices:
            raise ValueError(
                f"knob {name}: {value!r} is off the ladder {list(k.choices)}"
            )
        k.set(value)

    def _index(self, k: Knob) -> int:
        cur = k.get()
        if cur in k.choices:
            return k.choices.index(cur)
        # drifted off-ladder (some other writer): snap to the nearest
        # rung rather than raising from the controller's tick
        diffs = [
            (abs(float(c) - float(cur)), i) for i, c in enumerate(k.choices)
        ]
        return min(diffs)[1]

    def peek_step(self, name: str, direction: int) -> Tuple[Any, Any]:
        """(old, new) a one-rung step WOULD produce, without applying.
        Clamped at the ladder ends (old == new there)."""
        k = self._knobs[name]
        i = self._index(k)
        j = min(len(k.choices) - 1, max(0, i + (1 if direction > 0 else -1)))
        return k.get(), k.choices[j]

    def step(self, name: str, direction: int) -> Tuple[Any, Any]:
        """Move one rung along the ladder; returns (old, new)."""
        old, new = self.peek_step(name, direction)
        if new != old:
            self._knobs[name].set(new)
        return old, new

    def snapshot_block(self) -> Dict[str, Any]:
        """The ``knobs`` telemetry block. Additive to the snapshot
        schema — SCHEMA_VERSION unchanged, per the stability contract in
        telemetry.py."""
        block: Dict[str, Any] = {"schema": 1, "knobs": {}}
        for n in self.names():
            k = self._knobs[n]
            block["knobs"][n] = {
                "value": k.get(),
                "choices": list(k.choices),
                "lo": k.choices[0],
                "hi": k.choices[-1],
                "unit": k.unit,
            }
        if self.posture_source is not None:
            try:
                block["controller"] = self.posture_source()
            except Exception:  # degrade, don't take telemetry down
                log.exception("controller posture source failed")
        return block


def _ladder(*vals: Any) -> Tuple[Any, ...]:
    """Dedup + ascending sort — ladders built around a live initial
    value must stay canonical regardless of how the parts overlap."""
    return tuple(sorted(set(vals)))


def _fanout(objs: Sequence[Any], attr: str, cast=int) -> Callable[[Any], None]:
    def setter(v: Any) -> None:
        for o in objs:
            setattr(o, attr, cast(v))

    return setter


def registry_for_committee(com) -> KnobRegistry:
    """The standard knob set over a LocalCommittee.

    Every knob degrades to absent when its subsystem is (hasattr-guarded
    — an unsigned committee has no VerifyService, a non-speculative one
    no SpeculationEngine). Setters fan out to EVERY replica so the
    committee moves as one; getters read the first replica (they are
    built identically and only this registry writes them)."""
    reg = KnobRegistry()
    reps = list(getattr(com, "replicas", []) or [])
    if not reps:
        return reg
    r0 = reps[0]

    wm = int(r0.shed_watermark)
    reg.register(Knob(
        name="replica.shed_watermark",
        doc="inbox sweep size above which deferrable traffic is shed",
        # mid rungs (1.5x steps) above the configured watermark give
        # the knee-seeking traffic rules resolution where it matters:
        # the capacity knee usually sits between "configured" and
        # "configured x4", and a pure power-of-two ladder straddles it
        choices=_ladder(
            max(8, wm // 8), max(8, wm // 4), max(8, wm // 2),
            wm, wm * 3 // 2, wm * 2, wm * 3, wm * 4,
        ),
        get=lambda: reps[0].shed_watermark,
        set=_fanout(reps, "shed_watermark"),
        unit="msgs",
    ))
    md = int(r0.max_drain)
    reg.register(Knob(
        name="replica.max_drain",
        doc="max messages decoded per inbox sweep",
        choices=_ladder(max(64, md // 2), md, md * 2),
        get=lambda: reps[0].max_drain,
        set=_fanout(reps, "max_drain"),
        unit="msgs",
    ))

    engines = [r.spec for r in reps if getattr(r, "spec", None) is not None]
    if engines:
        sd = int(engines[0].max_depth)
        reg.register(Knob(
            name="spec.max_depth",
            doc="max concurrently open speculative slots",
            choices=_ladder(
                max(2, sd // 16), max(2, sd // 8), max(2, sd // 4),
                max(2, sd // 2), sd,
            ),
            get=lambda: engines[0].max_depth,
            set=_fanout(engines, "max_depth"),
            unit="slots",
        ))

    svcs = []
    seen = set()
    for r in reps:
        svc = getattr(r, "verifier", None)
        if svc is not None and hasattr(svc, "_max_batch") and id(svc) not in seen:
            seen.add(id(svc))
            svcs.append(svc)
    if svcs:
        mb = int(svcs[0]._max_batch)
        reg.register(Knob(
            name="verify.max_batch",
            # ladder CEILING == the constructor value: that is the top
            # bucket the warmup ladder compiled, so every rung is a
            # warmed shape — zero post-warm compiles by construction
            # (PBL006; the campaign gate pins the counter at 0)
            doc="coalesced verify batch cap (warmed-bucket ladder only)",
            choices=_ladder(
                max(64, mb // 8), max(64, mb // 4), max(64, mb // 2), mb,
            ),
            get=lambda: svcs[0]._max_batch,
            set=_fanout(svcs, "_max_batch"),
            unit="items",
        ))
        cut = svcs[0]._fixed_cutoff

        def _set_cutoff(v: Any) -> None:
            for s in svcs:
                # -1 is the ladder's "adaptive" rung: restore the
                # measured-throughput crossover (coalesce.py)
                s._fixed_cutoff = None if int(v) < 0 else int(v)

        reg.register(Knob(
            name="verify.cpu_cutoff",
            doc="max items taking the CPU path (-1 = adaptive crossover)",
            choices=_ladder(16, 64, 256, 1024) + (-1,),
            get=lambda: (
                -1 if svcs[0]._fixed_cutoff is None else svcs[0]._fixed_cutoff
            ),
            set=_set_cutoff,
            unit="items",
        ))
        mp = int(svcs[0]._max_pending)
        reg.register(Knob(
            name="verify.max_pending",
            doc="verify admission backlog cap before overload rejection",
            choices=_ladder(max(256, mp // 2), mp, mp * 2),
            get=lambda: svcs[0]._max_pending,
            set=_fanout(svcs, "_max_pending"),
            unit="items",
        ))

    try:
        from .consensus.qc import qc_lane

        lane = qc_lane()
    except Exception:  # qc stack unavailable: knobs absent, not fatal
        lane = None
    if lane is not None:
        cw_ms = round(lane._close_window * 1000.0, 3)

        def _set_cw(v: Any) -> None:
            lane._close_window = float(v) / 1000.0

        reg.register(Knob(
            name="qc.close_window_ms",
            doc="QC-lane batch close window (collect longer vs reply sooner)",
            choices=_ladder(0.5, 1.0, cw_ms, 4.0, 8.0),
            get=lambda: round(lane._close_window * 1000.0, 3),
            set=_set_cw,
            unit="ms",
        ))
        qb = int(lane._max_batch)
        reg.register(Knob(
            name="qc.max_batch",
            # same warmed-ceiling argument as verify.max_batch: the RLC
            # pairing batches never grow past what the lane already ran
            doc="QC-lane pairing batch cap (warmed ladder only)",
            choices=_ladder(max(16, qb // 4), max(16, qb // 2), qb),
            get=lambda: lane._max_batch,
            set=_fanout([lane], "_max_batch"),
            unit="certs",
        ))
    return reg


# ---------------------------------------------------------------------------
# rule catalogue
# ---------------------------------------------------------------------------

#: hysteresis / thresholds (module constants so tests can pin TP/TN
#: cases against the exact boundaries)
WIN_P99_STORM_MS = 300.0   # last-window p99 that reads as queue buildup
WIN_P99_FAST_MS = 150.0    # ...and the committee-is-fast band below it
STORM_SHED_FLOOR = 128.0   # shed/tick above max(2*wm, floor) = storm
RELAX_SERVED_RATIO = 0.8   # fresh inflow served fraction gating relax
CALM_TICKS = 3             # quiet ticks before the idle-trim rules act
PAD_WASTE_PCT = 40.0       # devledger pad-waste verdict threshold
PAD_OCCUPANCY = 0.5        # ...only while the device is underfilled
QUEUE_PRESSURE = 0.75      # verify pending / max_pending
CPU_SHARE = 0.5            # cpu-path item share that reads host-bound
GAP_OCCUPANCY = 0.2        # dispatch-gap verdict: starved device
GAP_DISPATCHES = 4         # ...fed by many small dispatches per tick
QC_PRESSURE = 0.5          # qc pending / max_pending


@dataclass(frozen=True)
class Rule:
    """One decision rule: a pure predicate over the flat signal view.

    ``needs`` lists exactly the view keys the predicate reads — the
    controller records that subset as the action's ``trigger``, which is
    what makes :func:`replay_ledger` possible: feeding the trigger back
    through ``fires`` must re-derive the decision."""

    name: str
    family: str
    knob: str
    direction: int
    needs: Tuple[str, ...]
    fires: Callable[[Dict[str, Any]], bool]

    def trigger(self, view: Dict[str, Any]) -> Dict[str, Any]:
        return {k: view.get(k, 0) for k in self.needs}


def _g(view: Dict[str, Any], key: str) -> float:
    try:
        return float(view.get(key, 0) or 0)
    except (TypeError, ValueError):
        return 0.0


#: priority-ordered catalogue: the FIRST firing rule whose step is not a
#: no-op acts this tick. Shrink-under-pressure rules outrank relax
#: rules — the controller must react to a storm before it optimizes an
#: idle committee.
RULES: Tuple[Rule, ...] = (
    # -- traffic family: storm cut vs drain relax ----------------------
    # The pair below splits on shed MAGNITUDE, so cut and relax are
    # mutually exclusive over any single view.  A storm sheds hundreds
    # of requests per tick (offered far above the watermark); benign
    # over-trim sheds a trickle.  Cutting hard during a storm converts
    # slow-drip retry chains into fast client timeouts and keeps every
    # ADMITTED request fast — fail-fast brownout, the point of the
    # shed plane.  Queue buildup (window p99 inflating, since the
    # primary's pending_requests drains into in-flight blocks
    # instantly and the real backlog lives in the WAN links'
    # serialization queues) also reads as storm.  Admission-gap
    # ratios are deliberately NOT used: a gap cannot distinguish
    # queue collapse (admit less) from over-shedding (admit more).
    Rule(
        name="storm_backlog", family="traffic",
        knob="replica.shed_watermark", direction=-1,
        needs=("shed_delta", "win_p99_ms", "backlog", "shed_watermark"),
        fires=lambda v: (
            _g(v, "shed_delta")
            > max(2.0 * _g(v, "shed_watermark"), STORM_SHED_FLOOR)
            or _g(v, "win_p99_ms") > WIN_P99_STORM_MS
            or _g(v, "backlog") > _g(v, "shed_watermark")
        ),
    ),
    Rule(
        # relax ONLY when fresh inflow is essentially fully served and
        # the committee is fast while sheds still happen: the watermark
        # sits below the benign sweep size and is trimming traffic the
        # committee could absorb.  The served-ratio term is the safety
        # interlock: a strangled post-storm backlog (fresh inflow NOT
        # served) must never trigger relaxation, because admitting a
        # patience-aged retry backlog converts invisible timeouts into
        # a guaranteed multi-second p99 tail.  Expired backlog washes
        # out within client patience; until then the debt stands.  A
        # calm committee never fires this — no shed, no reason to move.
        name="drain_relax", family="traffic",
        knob="replica.shed_watermark", direction=+1,
        needs=("shed_delta", "win_p99_ms", "offered_req_s",
               "accepted_req_s"),
        fires=lambda v: (
            _g(v, "shed_delta") > 0
            and _g(v, "win_p99_ms") < WIN_P99_FAST_MS
            and _g(v, "offered_req_s") > 0
            and _g(v, "accepted_req_s")
            >= RELAX_SERVED_RATIO * _g(v, "offered_req_s")
        ),
    ),
    # -- devledger family: pad waste / queue wait vs batch bucket ------
    Rule(
        name="pad_waste", family="devledger",
        knob="verify.max_batch", direction=-1,
        needs=("pad_waste_pct", "occupancy"),
        fires=lambda v: (
            _g(v, "pad_waste_pct") >= PAD_WASTE_PCT
            and _g(v, "occupancy") < PAD_OCCUPANCY
        ),
    ),
    Rule(
        name="queue_wait", family="devledger",
        knob="verify.max_batch", direction=+1,
        needs=("verify_queue_ratio", "queue_wait_delta_s"),
        fires=lambda v: (
            _g(v, "verify_queue_ratio") >= QUEUE_PRESSURE
            or _g(v, "queue_wait_delta_s") > 0.1
        ),
    ),
    # -- costmodel family: limiter verdicts (host-bound / dispatch gap)
    Rule(
        name="host_cpu_path", family="costmodel",
        knob="verify.cpu_cutoff", direction=-1,
        needs=("cpu_share", "verify_pending"),
        fires=lambda v: (
            _g(v, "cpu_share") >= CPU_SHARE and _g(v, "verify_pending") > 0
        ),
    ),
    Rule(
        name="dispatch_gap", family="costmodel",
        knob="verify.max_batch", direction=+1,
        needs=("occupancy", "dispatch_delta"),
        fires=lambda v: (
            0 < _g(v, "occupancy") < GAP_OCCUPANCY
            and _g(v, "dispatch_delta") >= GAP_DISPATCHES
        ),
    ),
    # -- qc family: pairing-lane pressure vs close window --------------
    Rule(
        name="qc_pressure", family="qc",
        knob="qc.close_window_ms", direction=+1,
        needs=("qc_pending_ratio", "qc_batch_headroom"),
        fires=lambda v: (
            _g(v, "qc_pending_ratio") >= QC_PRESSURE
            or (0 < _g(v, "qc_batch_headroom") <= 0.1)
        ),
    ),
    Rule(
        name="qc_idle", family="qc",
        knob="qc.close_window_ms", direction=-1,
        needs=("qc_pending", "calm_ticks"),
        fires=lambda v: (
            _g(v, "qc_pending") == 0 and _g(v, "calm_ticks") >= CALM_TICKS
        ),
    ),
    # -- spec family: rollback churn vs speculation depth --------------
    Rule(
        name="spec_churn", family="spec",
        knob="spec.max_depth", direction=-1,
        needs=("spec_rollback_delta",),
        fires=lambda v: _g(v, "spec_rollback_delta") > 0,
    ),
    Rule(
        name="spec_stable", family="spec",
        knob="spec.max_depth", direction=+1,
        needs=("spec_rollback_delta", "calm_ticks"),
        fires=lambda v: (
            _g(v, "spec_rollback_delta") == 0
            and _g(v, "calm_ticks") >= CALM_TICKS
        ),
    ),
)

RULES_BY_NAME: Dict[str, Rule] = {r.name: r for r in RULES}


# ---------------------------------------------------------------------------
# decision ledger
# ---------------------------------------------------------------------------


class DecisionLedger:
    """Hash-chained JSONL decision ledger (``<id>.knobs.jsonl``).

    Same chain discipline as the audit plane's evidence ledger: every
    record carries ``prev`` (previous record's hash, GENESIS first) and
    ``h`` = sha256 of its own canonical body. Writes go through the
    telemetry ``_JsonlSink`` (line-flushed, degrade-don't-raise) —
    ``json.dumps(sort_keys=True)`` makes the bytes deterministic, so a
    seeded sim run reproduces the ledger byte for byte."""

    def __init__(self, path: str):
        import os

        from .telemetry import _JsonlSink

        self.path = path
        # a decision ledger is one run's chain: truncate any stale file
        # so the genesis record is always line 1 (the sink appends)
        try:
            if os.path.exists(path):
                os.remove(path)
        except OSError:
            pass
        self._sink = _JsonlSink(path)
        self._prev = GENESIS
        self.records = 0

    def append(self, kind: str, **fields: Any) -> str:
        rec: Dict[str, Any] = {
            "schema": LEDGER_SCHEMA_VERSION, "kind": kind,
            "t": round(clock.now(), 3),
        }
        rec.update(fields)
        rec["prev"] = self._prev
        rec["h"] = chain_hash(rec)
        self._sink.write(rec)
        self._prev = rec["h"]
        self.records += 1
        return rec["h"]

    def close(self) -> None:
        self._sink.close()


def parse_decision_ledger(path: str) -> Tuple[List[Dict[str, Any]], str]:
    """Parse + verify a decision ledger. Returns (records, error) —
    error is "" when every line parses, hashes, and chains."""
    records: List[Dict[str, Any]] = []
    prev = GENESIS
    try:
        with open(path) as fh:
            for i, line in enumerate(fh):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    return records, f"line {i}: unparseable"
                if rec.get("schema") != LEDGER_SCHEMA_VERSION:
                    return records, f"line {i}: schema mismatch"
                if rec.get("prev") != prev:
                    return records, f"line {i}: chain break"
                if chain_hash(rec) != rec.get("h"):
                    return records, f"line {i}: hash mismatch"
                prev = rec["h"]
                records.append(rec)
    except OSError as e:
        return records, f"unreadable: {e}"
    return records, ""


def replay_ledger(
    records: Sequence[Dict[str, Any]],
    rules: Dict[str, Rule] = RULES_BY_NAME,
) -> Tuple[bool, str]:
    """Re-derive every action from the ledger alone (replay
    acceptance): each action's recorded trigger must re-fire its rule,
    the step direction must match the rule, per-knob old → new values
    must chain from the open record to the close record."""
    if not records or records[0].get("kind") != "open":
        return False, "no open record"
    values: Dict[str, Any] = dict(records[0].get("knobs", {}))
    for i, rec in enumerate(records):
        if rec.get("kind") != "action":
            continue
        rule = rules.get(rec.get("rule", ""))
        if rule is None:
            return False, f"record {i}: unknown rule {rec.get('rule')!r}"
        if rule.knob != rec.get("knob"):
            return False, f"record {i}: rule/knob mismatch"
        if rule.direction != rec.get("direction"):
            return False, f"record {i}: rule/direction mismatch"
        if not rule.fires(dict(rec.get("trigger", {}))):
            return False, f"record {i}: trigger does not re-fire {rule.name}"
        knob = rec["knob"]
        if knob in values and values[knob] != rec.get("old"):
            return False, (
                f"record {i}: {knob} old={rec.get('old')!r} breaks "
                f"continuity (expected {values[knob]!r})"
            )
        values[knob] = rec.get("new")
    last = records[-1]
    if last.get("kind") == "close":
        for knob, v in (last.get("knobs") or {}).items():
            if knob in values and values[knob] != v:
                return False, f"close: {knob} final {v!r} != replayed {values[knob]!r}"
    return True, ""


# ---------------------------------------------------------------------------
# the online controller
# ---------------------------------------------------------------------------


class KnobController:
    """Off-loop online tuner: one telemetry snapshot → one flat signal
    view → at most one knob step per tick, everything ledgered.

    ``snapshot_fn`` is any zero-arg callable returning a NodeTelemetry-
    shaped snapshot dict (sim passes the primary's registry; a live node
    could pass its StatusServer source). ``tick(snap)`` is synchronous
    and accepts an explicit snapshot, so unit tests drive rules without
    a running loop."""

    def __init__(
        self,
        registry: KnobRegistry,
        snapshot_fn: Callable[[], Dict[str, Any]],
        ledger_path: Optional[str] = None,
        *,
        interval: float = 0.5,
        profile: str = "default",
        cooldown_ticks: int = 2,
        effect_ticks: int = 2,
        osc_window_ticks: int = 6,
        freeze_ticks: int = 8,
        rules: Sequence[Rule] = RULES,
    ) -> None:
        self.registry = registry
        self.snapshot_fn = snapshot_fn
        self.interval = interval
        self.profile = profile
        self.cooldown_ticks = cooldown_ticks
        self.effect_ticks = effect_ticks
        self.osc_window_ticks = osc_window_ticks
        self.freeze_ticks = freeze_ticks
        self.rules = tuple(rules)
        self.ledger = DecisionLedger(ledger_path) if ledger_path else None
        self.actions = 0
        self.oscillations = 0
        self.ticks = 0
        self._task: Optional[asyncio.Task] = None
        self._prev_counters: Dict[str, float] = {}
        self._calm = 0
        # knob -> (tick, direction) of the last APPLIED action
        self._last_action: Dict[str, Tuple[int, int]] = {}
        self._frozen: Dict[str, int] = {}  # knob -> unfreeze tick
        # (due_tick, action_h, rule, knob, before-signals)
        self._effects: List[Tuple[int, str, str, str, Dict[str, Any]]] = []
        self._last_info: Optional[Dict[str, Any]] = None
        registry.posture_source = self.posture

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self.ledger is not None:
            self.ledger.append(
                "open", profile=self.profile,
                interval=self.interval, knobs=self.registry.values(),
            )
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        while True:
            await clock.sleep(self.interval)
            try:
                self.tick()
            except Exception:
                # the controller must never take down the run it tunes
                log.exception("controller tick failed")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        self._flush_effects(final=True)
        if self.ledger is not None:
            self.ledger.append(
                "close", tick=self.ticks, knobs=self.registry.values(),
                actions=self.actions, oscillations=self.oscillations,
            )
            self.ledger.close()

    # -- signal view -------------------------------------------------------

    def _view(self, snap: Dict[str, Any]) -> Dict[str, Any]:
        """Distill a node snapshot into the flat signal dict the rules
        read. Every source block is optional — absent surfaces read as
        0 and their rules simply never fire (degrade, don't raise)."""
        v: Dict[str, Any] = {}
        tr = snap.get("traffic") or {}
        v["offered_req_s"] = tr.get("offered_req_s", 0)
        v["accepted_req_s"] = tr.get("accepted_req_s", 0)
        v["worst_p99_ms"] = tr.get("worst_p99_ms", 0)
        # last CLOSED window's worst honest p99: the queue-buildup
        # signal (cumulative p99 above is too sticky to steer by)
        byz = {
            n for n, c in (tr.get("classes") or {}).items()
            if c.get("byzantine")
        }
        wt = tr.get("windows_tail") or []
        wc = (wt[-1].get("classes") or {}) if wt else {}
        v["win_p99_ms"] = max(
            (c.get("p99_ms", 0) for n, c in sorted(wc.items())
             if n not in byz),
            default=0,
        )
        rep = snap.get("replica") or {}
        v["backlog"] = (
            rep.get("pending_requests", 0) + rep.get("relay_buffer", 0)
        )
        met = rep.get("metrics") or {}
        ver = snap.get("verify") or {}
        dev = ver.get("device") or {}
        v["occupancy"] = dev.get("occupancy", 0)
        v["pad_waste_pct"] = dev.get("pad_waste_pct", 0)
        v["verify_pending"] = ver.get("pending_items", 0)
        vmp = ver.get("max_pending", 0) or 0
        v["verify_queue_ratio"] = (
            v["verify_pending"] / vmp if vmp else 0.0
        )
        qc = snap.get("qc_lane") or {}
        v["qc_pending"] = qc.get("pending", 0)
        qmp = qc.get("max_pending", 0) or 0
        v["qc_pending_ratio"] = v["qc_pending"] / qmp if qmp else 0.0
        if "qc.max_batch" in self.registry:
            qmb = float(self.registry.value("qc.max_batch"))
            bm = float(qc.get("batch_mean", 0) or 0)
            v["qc_batch_headroom"] = (
                max(0.0, (qmb - bm) / qmb) if qmb and bm else 0.0
            )
        else:
            v["qc_batch_headroom"] = 0.0
        # cumulative counters -> per-tick deltas
        cum = {
            "shed": float(met.get("messages_shed", 0) or 0),
            "rollbacks": float(met.get("spec_rollbacks", 0) or 0),
            "queue_wait_s": float(dev.get("queue_wait_s", 0) or 0),
            "dispatches": float(dev.get("dispatches", 0) or 0),
            "cpu_items": float(ver.get("cpu_pass_items", 0) or 0),
            "dev_items": float(ver.get("device_pass_items", 0) or 0),
        }
        prev = self._prev_counters
        d = {k: max(0.0, cum[k] - prev.get(k, 0.0)) for k in cum}
        self._prev_counters = cum
        v["shed_delta"] = d["shed"]
        v["spec_rollback_delta"] = d["rollbacks"]
        v["queue_wait_delta_s"] = round(d["queue_wait_s"], 4)
        v["dispatch_delta"] = d["dispatches"]
        items = d["cpu_items"] + d["dev_items"]
        v["cpu_share"] = round(d["cpu_items"] / items, 3) if items else 0.0
        # live knob values the rules compare signals against
        for name in ("replica.shed_watermark",):
            if name in self.registry:
                v["shed_watermark"] = self.registry.value(name)
        v["calm_ticks"] = self._calm
        return v

    def _effect_signals(self, view: Dict[str, Any]) -> Dict[str, Any]:
        return {
            k: view.get(k, 0)
            for k in ("worst_p99_ms", "accepted_req_s", "occupancy",
                      "qc_pending", "backlog")
        }

    # -- the tick ----------------------------------------------------------

    def tick(self, snap: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """One decision round; returns the fired rule's name (or None).
        Synchronous and snapshot-injectable for tests."""
        self.ticks += 1
        if snap is None:
            snap = self.snapshot_fn() or {}
        view = self._view(snap)
        self._flush_effects(view=view)
        fired: Optional[str] = None
        for rule in self.rules:
            if rule.knob not in self.registry:
                continue
            if not rule.fires(view):
                continue
            if self._frozen.get(rule.knob, 0) > self.ticks:
                continue
            last = self._last_action.get(rule.knob)
            if last is not None and self.ticks - last[0] < self.cooldown_ticks:
                continue
            old, new = self.registry.peek_step(rule.knob, rule.direction)
            if new == old:
                continue  # clamped at the ladder end: not a decision
            if last is not None and last[1] != rule.direction and (
                self.ticks - last[0] <= self.osc_window_ticks
            ):
                # oscillation guard: a reversal hot on the heels of the
                # opposite step means the two rules are fighting over
                # this knob — freeze it instead of flapping it
                self.oscillations += 1
                until = self.ticks + self.freeze_ticks
                self._frozen[rule.knob] = until
                if self.ledger is not None:
                    self.ledger.append(
                        "guard", tick=self.ticks, knob=rule.knob,
                        rule=rule.name, until_tick=until,
                        trigger=rule.trigger(view),
                    )
                fired = None
                break
            self.registry.step(rule.knob, rule.direction)
            self.actions += 1
            self._last_action[rule.knob] = (self.ticks, rule.direction)
            self._last_info = {
                "rule": rule.name, "knob": rule.knob, "old": old,
                "new": new, "tick": self.ticks, "t": round(clock.now(), 3),
            }
            if self.ledger is not None:
                h = self.ledger.append(
                    "action", tick=self.ticks, rule=rule.name,
                    family=rule.family, knob=rule.knob,
                    direction=rule.direction, old=old, new=new,
                    trigger=rule.trigger(view),
                )
                self._effects.append((
                    self.ticks + self.effect_ticks, h, rule.name,
                    rule.knob, self._effect_signals(view),
                ))
            fired = rule.name
            break
        # hysteresis state for the relax rules: a tick is calm when
        # admission is healthy and nothing was shed
        if (
            _g(view, "shed_delta") == 0
            and _g(view, "offered_req_s")
            <= 1.05 * max(_g(view, "accepted_req_s"), 1.0)
        ):
            self._calm += 1
        else:
            self._calm = 0
        return fired

    def _flush_effects(
        self, view: Optional[Dict[str, Any]] = None, final: bool = False
    ) -> None:
        if self.ledger is None:
            return
        due: List[Tuple[int, str, str, str, Dict[str, Any]]] = []
        keep: List[Tuple[int, str, str, str, Dict[str, Any]]] = []
        for e in self._effects:
            (due if final or e[0] <= self.ticks else keep).append(e)
        self._effects = keep
        after = self._effect_signals(view) if view is not None else {}
        for due_tick, h, rule, knob, before in due:
            self.ledger.append(
                "effect", tick=self.ticks, action_h=h, rule=rule,
                knob=knob, before=before, after=after,
            )

    # -- posture (pbft_top CTL column / knobs telemetry block) -------------

    def posture(self) -> Dict[str, Any]:
        frozen = {
            k: t for k, t in sorted(self._frozen.items()) if t > self.ticks
        }
        p: Dict[str, Any] = {
            "profile": self.profile,
            "tick": self.ticks,
            "actions": self.actions,
            "oscillations": self.oscillations,
            "guard": {"frozen": frozen},
        }
        if self._last_info is not None:
            p["last"] = dict(self._last_info)
            p["last_age_s"] = round(
                max(0.0, clock.now() - self._last_info["t"]), 3
            )
        return p

    def coverage(self) -> Dict[str, Any]:
        """Flat summary sim.py folds into scenario coverage/details."""
        return {
            "ticks": self.ticks,
            "actions": self.actions,
            "oscillations": self.oscillations,
            "ledger_records": self.ledger.records if self.ledger else 0,
        }
