"""verify_observatory: measured roofline attribution for the verify path.

Recomputes, per run, where the verify path's time goes, from live
artifacts:

- the **device ledger** (``simple_pbft_tpu_torch/devledger.py``):
  per-dispatch (mode, window, bucket, pad, queue wait, host prep, RTT,
  compile, bytes) aggregates riding every flight frame / bench record;
- the **span layer** (``*.spans.jsonl``): the independent service-side
  measurement the ledger must reconcile with (within 15%, the
  acceptance bar; a bigger gap means one of the two surfaces lies);
- the **static cost model** (``crypto/costmodel.py``): analytic
  table-gather bytes per (mode, window, bucket), turning measured
  dispatch counts into achieved gather bandwidth.

Output: a per-run verdict (achieved vs peak gather bandwidth, device
occupancy, host-overhead share, and the dominant limiter: ``bandwidth``
/ ``dispatch_gap`` / ``host_prep`` / ``queue_starvation`` /
``host_cpu_path``) with ``--json`` for CI (a device smoke gates on
shares summing to 1 and the reconciliation bound).

Sources (combine freely):
  --log-dir/--flight-dir DIR   *.flight.jsonl tails (device blocks) +
                               *.spans.jsonl (stage table)
  --bench-record F [--cell C]  a bench/campaign ledger line carrying
                               ``device`` + ``spans`` blocks
  --platform h100 | --peak-gather-gbps X   roofline denominator
                               (omit on CPU backends: utilization null)

Reads files only; no kernel runs and no card is needed:

  python -m simple_pbft_tpu_torch.tools.verify_observatory \
      --flight-dir D --platform h100 --json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional

from ..crypto import costmodel
from ..devledger import (
    LANE_SUM_KEYS,
    TOP_MIRROR_KEYS,
    lane_view,
)
from ..telemetry import load_bench_ledger
from . import critical_path

RECONCILE_TOLERANCE_PCT = 15.0


def merge_device_blocks(blocks: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Sum per-PROCESS ``device`` blocks (one ledger per process) into
    one committee-wide view. Raw counters add; rates/fractions are
    recomputed against the widest window.

    Blocks carrying the same ``node`` id are THE SAME process-wide
    ledger seen through different files — an in-process committee
    writes n per-replica flight files all embedding one ledger — and
    dedup to the latest frame instead of n-fold-counting (which would
    both inflate every rate and trip the reconciliation bar on a
    healthy run). Id-less blocks (older frames) pass through as-is."""
    deduped: Dict[str, Dict[str, Any]] = {}
    passthrough: List[Dict[str, Any]] = []
    for b in blocks:
        nid = b.get("node")
        if nid:
            deduped[nid] = b  # latest frame per process wins
        else:
            passthrough.append(b)
    blocks = list(deduped.values()) + passthrough
    lanes: Dict[str, Dict[str, float]] = {}
    shapes: Dict[str, Dict[str, int]] = {}
    devices: Dict[str, int] = {}
    window = 0.0
    for b in blocks:
        window = max(window, float(b.get("window_s", 0.0)))
        for lane, row in (b.get("lanes") or {}).items():
            agg = lanes.setdefault(lane, {k: 0 for k in LANE_SUM_KEYS})
            for k in LANE_SUM_KEYS:
                agg[k] += row.get(k, 0)
            # each block is one PROCESS's ledger, so its devices are
            # distinct hardware: device counts SUM across blocks (a max
            # would divide 4 nodes' summed busy seconds by one node's
            # device count and report a saturated committee of idle
            # devices), and merged occupancy normalizes by the fleet
            devices[lane] = devices.get(lane, 0) + int(
                row.get("devices", 1)
            )
        for key, row in (b.get("shapes") or {}).items():
            cell = shapes.setdefault(
                key, {"dispatches": 0, "items": 0, "pad_items": 0}
            )
            for k in cell:
                cell[k] += int(row.get(k, 0))
    window = max(window, 1e-9)
    out_lanes = {}
    for lane, agg in sorted(lanes.items()):
        # derived metrics come from THE shared definition
        # (devledger.lane_view) — no second copy of the formulas to
        # drift; only the device-count semantics are merge-specific
        # (summed across blocks, handled above)
        out_lanes[lane] = lane_view(agg, window, devices.get(lane, 1))
    top = out_lanes.get("ed25519") or (
        next(iter(out_lanes.values())) if out_lanes else {}
    )
    merged: Dict[str, Any] = {
        "window_s": round(window, 3),
        "processes": len(blocks),
        "lanes": out_lanes,
        "shapes": shapes,
    }
    for k in TOP_MIRROR_KEYS:
        merged[k] = top.get(k, 0)
    return merged


def _stage_total_ms(stages: Dict[str, Any], name: str) -> float:
    """Total ms of one stage from either a critical_path stage table
    (``total_ms``) or a bench record's Histogram summaries
    (``mean * count``)."""
    row = stages.get(name) or {}
    if "total_ms" in row:
        return float(row["total_ms"])
    return float(row.get("mean", 0.0)) * float(row.get("count", 0))


# the limiters dominant_limiter names for a run with device dispatches on
# a gather path (the fused and comb modes)
LIMITERS = ("bandwidth", "dispatch_gap", "host_prep", "queue_starvation", "host_cpu_path")


def dominant_limiter(
    shares: Dict[str, float], device: Dict[str, Any],
    gather_bytes: int,
) -> str:
    """Name the verify path's limiter from the measured decomposition.

    Ordered by what the biggest latency share means, with occupancy
    disambiguating the two device-flavored cases: a device-busy-
    dominated path on a SATURATED device is resource-bound (bandwidth
    for the table engines, compute for the gather-free ladder); the
    same share on an idle
    device means the pipeline isn't feeding it (queue starvation). A
    queue-wait-dominated path splits the same way: saturated device =
    backpressure (still bandwidth), idle device = the dispatcher is
    leaving gaps.
    """
    if not device.get("dispatches"):
        return "no_device_dispatches"
    occ = float(device.get("occupancy", 0.0))
    top = max(shares, key=lambda k: shares[k]) if shares else "device_busy"
    if top == "device_busy":
        if occ < 0.5:
            return "queue_starvation"
        return "bandwidth" if gather_bytes > 0 else "device_compute"
    if top == "host_prep":
        return "host_prep"
    if top == "queue_wait":
        if occ >= 0.6:
            return "bandwidth" if gather_bytes > 0 else "device_compute"
        return "dispatch_gap"
    if top == "cpu_path":
        return "host_cpu_path"
    return "unknown"


def analyze(
    device: Dict[str, Any],
    stages: Dict[str, Any],
    peak_gather_gbps: Optional[float] = None,
) -> Dict[str, Any]:
    """Join one merged device block with one stage table into the
    roofline verdict document."""
    busy_ms = float(device.get("busy_s", 0.0)) * 1e3
    prep_ms = float(device.get("host_prep_s", 0.0)) * 1e3
    queue_ms = float(device.get("queue_wait_s", 0.0)) * 1e3
    cpu_ms = (
        _stage_total_ms(stages, "verify.cpu")
        + _stage_total_ms(stages, "verify.cpu_reroute")
    )
    totals = {
        "device_busy": round(busy_ms, 3),
        "host_prep": round(prep_ms, 3),
        "queue_wait": round(queue_ms, 3),
        "cpu_path": round(cpu_ms, 3),
    }
    denom = sum(totals.values())
    shares = {
        k: (round(v / denom, 4) if denom > 0 else 0.0)
        for k, v in totals.items()
    }
    # make the shares sum to exactly 1.0 despite rounding (CI asserts)
    if denom > 0:
        drift = round(1.0 - sum(shares.values()), 4)
        top = max(shares, key=lambda k: shares[k])
        shares[top] = round(shares[top] + drift, 4)

    # independent-measurement reconciliation: the span layer timed the
    # same device passes from the SERVICE side (dispatch -> verdict,
    # host prep included); the ledger timed them from the verifier side
    # (prep and RTT split). The two must agree within tolerance or one
    # surface is lying — the acceptance bar this tool is gated on.
    spans_device_ms = _stage_total_ms(stages, "verify.device")
    ledger_device_ms = busy_ms + prep_ms
    base = max(spans_device_ms, ledger_device_ms, 1e-9)
    delta_pct = round(
        100.0 * abs(spans_device_ms - ledger_device_ms) / base, 2
    )
    reconciliation = {
        "ledger_device_ms": round(ledger_device_ms, 3),
        "spans_device_ms": round(spans_device_ms, 3),
        "delta_pct": delta_pct,
        "tolerance_pct": RECONCILE_TOLERANCE_PCT,
        "ok": (
            delta_pct <= RECONCILE_TOLERANCE_PCT
            # no spans on this surface (direct-driven verifier): nothing
            # to reconcile is not a reconciliation failure
            or spans_device_ms == 0.0
        ),
        "spans_queue_ms": round(_stage_total_ms(stages, "verify.queue"), 3),
        "ledger_queue_ms": round(queue_ms, 3),
    }

    shapes = device.get("shapes") or {}
    gather_bytes = costmodel.gather_bytes_for_shapes(shapes)
    busy_s = float(device.get("busy_s", 0.0))
    achieved = gather_bytes / busy_s / 1e9 if busy_s > 0 else 0.0
    per_shape = []
    for key, row in sorted(shapes.items()):
        parsed = costmodel.parse_shape_key(key)
        if parsed is None:
            continue
        cost = costmodel.shape_cost(
            parsed["mode"], parsed["window"], parsed["bucket"]
        )
        per_shape.append({
            "shape": key,
            "dispatches": row.get("dispatches", 0),
            "items": row.get("items", 0),
            "pad_items": row.get("pad_items", 0),
            "gather_bytes_per_item": cost["gather_bytes_per_item"],
            "madds_per_item": cost["madds_per_item"],
            "wire_bytes_per_item": cost["wire_bytes_per_item"],
            "gather_bytes_total": (
                cost["gather_bytes_per_pass"] * row.get("dispatches", 0)
            ),
        })
    roofline = {
        "gather_bytes": gather_bytes,
        "achieved_gather_gbps": round(achieved, 3),
        "peak_gather_gbps": peak_gather_gbps,
        # six places: the card's verify passes gather about 1e-4 of its
        # memory rate over their round trips, which three round to 0
        "utilization": (
            round(achieved / peak_gather_gbps, 6)
            if peak_gather_gbps else None
        ),
        "per_shape": per_shape,
    }
    return {
        "schema_version": 1,
        "window_s": device.get("window_s", 0.0),
        "device": device,
        "decomposition": {"totals_ms": totals, "shares": shares},
        "reconciliation": reconciliation,
        "roofline": roofline,
        "limiter": dominant_limiter(shares, device, gather_bytes),
    }


# ---------------------------------------------------------------------------
# source loading
# ---------------------------------------------------------------------------


def device_blocks_from_flights(log_dir: str) -> List[Dict[str, Any]]:
    """Last complete ``verify.device`` block of each node's flight
    timeline (the post-mortem path — a SIGKILLed node's ledger survives
    in its last flight frame)."""
    blocks = []
    for path in sorted(glob.glob(os.path.join(log_dir, "*.flight.jsonl"))):
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as fh:
                fh.seek(max(0, size - 512 * 1024))
                lines = [ln for ln in fh.read().split(b"\n") if ln.strip()]
        except OSError:
            continue
        for ln in reversed(lines):
            try:
                doc = json.loads(ln)
            except ValueError:
                continue  # torn final line mid-write
            dev = ((doc.get("verify") or {}).get("device")
                   if isinstance(doc, dict) else None)
            if dev and dev.get("lanes"):
                blocks.append(dev)
                break
    return blocks


def from_bench_record(path: str, cell: Optional[str]) -> Optional[Dict[str, Any]]:
    """(device block, stages) from a bench/campaign ledger line."""
    lines = load_bench_ledger(path)
    match = None
    for doc in lines:
        key = doc.get("cell") or doc.get("config")
        if cell is None or key == cell:
            if isinstance(doc.get("device"), dict):
                match = doc
    return match


def main() -> None:
    ap = argparse.ArgumentParser(
        description="measured roofline attribution for the GPU verify path"
    )
    ap.add_argument("files", nargs="*", help="span JSONL files to join")
    ap.add_argument("--log-dir", default=None,
                    help="discover *.flight.jsonl + *.spans.jsonl here")
    ap.add_argument("--flight-dir", default=None,
                    help="alias of --log-dir (bench --flight-dir output)")
    ap.add_argument("--bench-record", default=None,
                    help="bench/campaign ledger JSONL carrying device+spans "
                    "blocks (alternative to --log-dir)")
    ap.add_argument("--cell", default=None,
                    help="cell/config key inside --bench-record (default: "
                    "last line with a device block)")
    ap.add_argument("--platform", default=None,
                    choices=sorted(costmodel.PEAK_GATHER_GBPS),
                    help="named measured gather-bandwidth ceiling "
                    "(crypto/costmodel.py)")
    ap.add_argument("--peak-gather-gbps", type=float, default=None,
                    help="explicit roofline denominator, GB/s (overrides "
                    "--platform; omit on CPU backends)")
    ap.add_argument("--json", action="store_true",
                    help="emit the verdict as one JSON document")
    args = ap.parse_args()

    peak = args.peak_gather_gbps
    if peak is None and args.platform:
        peak = costmodel.PEAK_GATHER_GBPS[args.platform]

    device: Optional[Dict[str, Any]] = None
    stages: Dict[str, Any] = {}
    if args.bench_record:
        doc = from_bench_record(args.bench_record, args.cell)
        if doc is None:
            print("verify_observatory: no ledger line with a device block",
                  file=sys.stderr)
            sys.exit(1)
        device = merge_device_blocks([doc["device"]])
        stages = doc.get("spans") or {}
    else:
        span_paths = list(args.files)
        blocks: List[Dict[str, Any]] = []
        for d in (args.log_dir, args.flight_dir):
            if d:
                blocks.extend(device_blocks_from_flights(d))
                span_paths.extend(critical_path.discover(d))
        if not blocks:
            print("verify_observatory: no device ledger found (need "
                  "--log-dir with flight files or --bench-record)",
                  file=sys.stderr)
            sys.exit(1)
        device = merge_device_blocks(blocks)
        if span_paths:
            stages = critical_path._stage_table(
                critical_path.load_spans(span_paths)
            )

    verdict = analyze(device, stages, peak_gather_gbps=peak)
    if args.json:
        print(json.dumps(verdict, sort_keys=True))
    else:
        print(render(verdict))
    sys.exit(0 if verdict["device"].get("dispatches") else 1)


def render(v: Dict[str, Any]) -> str:
    d = v["device"]
    r = v["roofline"]
    rec = v["reconciliation"]
    lines = [
        f"verify_observatory: {d.get('dispatches', 0)} dispatches / "
        f"{d.get('items', 0)} verifies over {v['window_s']}s "
        f"({d.get('verifies_per_s_effective', 0)}/s effective)",
        f"-- device: occupancy {d.get('occupancy', 0) * 100:.1f}%  "
        f"pad waste {d.get('pad_waste_pct', 0):.1f}%  "
        f"{d.get('items_per_dispatch', 0)} items/dispatch  "
        f"{d.get('coalesced_subs_per_dispatch', 0)} subs/dispatch  "
        f"compiles {d.get('compiles', 0)}",
        "-- decomposition (per-item latency shares):",
    ]
    for k, frac in sorted(
        v["decomposition"]["shares"].items(), key=lambda kv: -kv[1]
    ):
        lines.append(
            f"   {k:<12} {frac * 100:5.1f}%  "
            f"({v['decomposition']['totals_ms'][k]:.1f} ms)"
        )
    util = (f"{r['utilization'] * 100:.0f}% of {r['peak_gather_gbps']} GB/s"
            if r["utilization"] is not None else "peak unknown")
    lines.append(
        f"-- roofline: {r['achieved_gather_gbps']} GB/s achieved table "
        f"gather ({util})"
    )
    for row in r["per_shape"]:
        lines.append(
            f"   {row['shape']:<16} {row['dispatches']:>6} passes  "
            f"{row['gather_bytes_per_item']:>7} B/item gather  "
            f"{row['madds_per_item']:>4} madds/item"
        )
    lines.append(
        f"-- reconciliation vs spans: ledger {rec['ledger_device_ms']:.1f} ms "
        f"vs spans {rec['spans_device_ms']:.1f} ms "
        f"(delta {rec['delta_pct']:.1f}%, tol {rec['tolerance_pct']:.0f}%) "
        f"{'OK' if rec['ok'] else 'DISAGREE'}"
    )
    lines.append(f"-- dominant limiter: {v['limiter']}")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
