"""critical_path: per-stage latency attribution from span JSONL.

Joins the span files written by simple_pbft_tpu_torch/spans.py (one
``<id>.spans.jsonl`` per node process, or the bench's single
``<config>.spans.jsonl``) and answers where a commit's latency goes.

Two views:

1. **Slot decomposition**: the three ``phase.*`` spans of one
   (node, view, seq) tile its pre-prepare-admission -> execution window
   exactly, so each completed slot decomposes into prepare-quorum wait,
   commit-quorum wait, and execution-hole wait. Per percentile of
   end-to-end latency the report prints the dominant-path shares:
   "at p99: 62% phase.prepare, 21% phase.commit, ...". The slot sums
   are the replicas' ``commit_ms`` histogram, split.
2. **Pipeline stages**: every stage's own latency distribution
   (verify.queue / verify.device / verify.cpu / qc.* / transport.queue /
   client.e2e), with counts and total time, so "coalesce wait dominates
   device RTT 3:1" is one table row comparison.

Usage:
  python -m simple_pbft_tpu_torch.tools.critical_path --log-dir dep/log
  python -m simple_pbft_tpu_torch.tools.critical_path --log-dir D --json
  python -m simple_pbft_tpu_torch.tools.critical_path r0.spans.jsonl \
      r1.spans.jsonl --pcts 50,99

Stdlib only.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# the span-ledger parse, discovery and percentile helpers (span_ledger)
from .span_ledger import (
    LEDGER_SCHEMA_VERSION,
    discover,
    load_spans,
    pctile as _pctile,
)

# keep in sync with simple_pbft_tpu_torch/spans.py PHASE_STAGES
PHASE_STAGES = ("phase.prepare", "phase.commit", "phase.execute")


def _stage_table(spans: List[dict]) -> Dict[str, Dict[str, float]]:
    by_stage: Dict[str, List[float]] = defaultdict(list)
    for s in spans:
        by_stage[s["stage"]].append(float(s["dur_ms"]))
    table = {}
    for stage, vals in sorted(by_stage.items()):
        vals.sort()
        table[stage] = {
            "count": len(vals),
            "mean_ms": round(sum(vals) / len(vals), 3),
            "p50_ms": round(_pctile(vals, 50), 3),
            "p90_ms": round(_pctile(vals, 90), 3),
            "p99_ms": round(_pctile(vals, 99), 3),
            "total_ms": round(sum(vals), 1),
        }
    return table


def _slots(spans: List[dict]) -> List[dict]:
    """Join phase.* spans by (node, view, seq); a slot is complete when
    its phase.execute span exists (the terminal stage — earlier stages
    may legitimately be absent on QC catch-up slots)."""
    acc: Dict[Tuple, Dict[str, float]] = defaultdict(dict)
    for s in spans:
        if s["stage"] in PHASE_STAGES and "seq" in s:
            key = (s.get("node"), s.get("view"), s["seq"])
            # first span wins: a re-proposed slot after failover records
            # under a new view, so keys never collide within a view
            acc[key].setdefault(s["stage"], float(s["dur_ms"]))
    slots = []
    for (node, view, seq), stages in acc.items():
        if "phase.execute" not in stages:
            continue  # still in flight (or the writer died mid-slot)
        slots.append({
            "node": node,
            "view": view,
            "seq": seq,
            "stages": stages,
            "e2e_ms": round(sum(stages.values()), 3),
        })
    slots.sort(key=lambda s: s["e2e_ms"])
    return slots


def _decompose(slots: List[dict], pcts: List[float]) -> List[dict]:
    """Per requested percentile of slot end-to-end latency: the mean
    share of each phase stage among the slots in the band at (and just
    below) that percentile — the dominant-path decomposition."""
    out = []
    n = len(slots)
    if n == 0:
        return out
    band_w = max(1, n // 10)
    for p in pcts:
        i = min(n - 1, max(0, int(p / 100.0 * n)))
        band = slots[max(0, i - band_w + 1): i + 1]
        tot = sum(s["e2e_ms"] for s in band) or 1e-9
        shares = {
            st: round(
                sum(s["stages"].get(st, 0.0) for s in band) / tot, 4
            )
            for st in PHASE_STAGES
        }
        out.append({
            "pct": p,
            "e2e_ms": round(slots[i]["e2e_ms"], 3),
            "band_slots": len(band),
            "shares": shares,
        })
    return out


def analyze(spans: List[dict], pcts: Optional[List[float]] = None) -> dict:
    slots = _slots(spans)
    return {
        "schema_version": LEDGER_SCHEMA_VERSION,
        "spans": len(spans),
        "nodes": sorted({s.get("node") for s in spans if s.get("node")}),
        "stages": _stage_table(spans),
        "slots_complete": len(slots),
        "slot_e2e_ms": {
            "p50": _pctile([s["e2e_ms"] for s in slots], 50),
            "p99": _pctile([s["e2e_ms"] for s in slots], 99),
            "mean": round(
                sum(s["e2e_ms"] for s in slots) / len(slots), 3
            ) if slots else 0.0,
        },
        "decomposition": _decompose(slots, pcts or [50.0, 90.0, 99.0]),
    }


def render(an: dict) -> str:
    lines = [
        f"critical_path: {an['spans']} spans from "
        f"{len(an['nodes'])} nodes, {an['slots_complete']} complete slots"
    ]
    if an["decomposition"]:
        lines.append("-- commit-path decomposition (per slot-latency pct):")
        for d in an["decomposition"]:
            shares = ", ".join(
                f"{frac * 100.0:.0f}% {stage.split('.', 1)[1]}"
                for stage, frac in sorted(
                    d["shares"].items(), key=lambda kv: -kv[1]
                )
                if frac > 0
            )
            lines.append(
                f"   p{d['pct']:<4.4g} e2e {d['e2e_ms']:9.2f} ms = {shares}"
            )
    lines.append("-- pipeline stages (ms):")
    lines.append(
        f"   {'STAGE':<22} {'COUNT':>7} {'MEAN':>9} {'P50':>9} "
        f"{'P99':>9} {'TOTAL':>11}"
    )
    for stage, row in an["stages"].items():
        lines.append(
            f"   {stage:<22} {row['count']:>7} {row['mean_ms']:>9.2f} "
            f"{row['p50_ms']:>9.2f} {row['p99_ms']:>9.2f} "
            f"{row['total_ms']:>11.1f}"
        )
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(
        description="per-stage latency attribution from span JSONL"
    )
    ap.add_argument("files", nargs="*", help="span JSONL files to join")
    ap.add_argument("--log-dir", default=None,
                    help="discover *.spans.jsonl (and spans.jsonl) here")
    ap.add_argument("--pcts", default="50,90,99",
                    help="comma-separated slot-latency percentiles")
    ap.add_argument("--json", action="store_true",
                    help="emit the analysis as one JSON document")
    args = ap.parse_args()

    paths = list(args.files)
    if args.log_dir:
        paths.extend(discover(args.log_dir))
    if not paths:
        print("critical_path: no span files (use --log-dir or name files)",
              file=sys.stderr)
        sys.exit(1)
    spans = load_spans(paths)
    if not spans:
        print(f"critical_path: no spans parsed from {len(paths)} files",
              file=sys.stderr)
        sys.exit(1)
    pcts = [float(p) for p in args.pcts.split(",") if p.strip()]
    an = analyze(spans, pcts)
    if args.json:
        print(json.dumps(an, sort_keys=True))
    else:
        print(render(an))


if __name__ == "__main__":
    main()
