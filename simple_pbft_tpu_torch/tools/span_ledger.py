"""span_ledger: the shared span-ledger loader.

One JSONL parse for every tool that reads the files written by
simple_pbft_tpu_torch/spans.py (``critical_path``, and through it
``verify_observatory``). The ledger carries three doc shapes:

  {"evt":"span", "stage", "node", "t_mono", "dur_ms"[, view, seq, ...]}
      one recorded stage duration (spans.SpanRecorder.record)
  {"evt":"edge", "phase", "view", "seq", "src", "node", "span",
   "t_send_us", "t_recv_us"}
      one cross-node message delivery: send timestamp from the wire's
      unsigned trace envelope (sender's clock), recv timestamp at the
      receiving transport's dequeue seam (receiver's clock)
  {"evt":"quorum", "node", "phase", "view", "seq", "quorum", "votes",
   "t_quorum_us", "margin_ms", "straggler", "order"}
      one certificate's vote arrival-order record at the collector

Torn final lines from a live or killed writer are skipped. Stdlib only.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

# --json schema stamp of critical_path's document: bump when a consumed
# or emitted doc shape changes incompatibly
LEDGER_SCHEMA_VERSION = 1


def load_ledger(paths: List[str]) -> Dict[str, List[dict]]:
    """Every parseable ledger doc across the given JSONL files, bucketed
    by evt kind: {"span": [...], "edge": [...], "quorum": [...]}."""
    out: Dict[str, List[dict]] = {"span": [], "edge": [], "quorum": []}
    for path in paths:
        try:
            with open(path) as fh:
                for ln in fh:
                    if not ln.strip():
                        continue
                    try:
                        doc = json.loads(ln)
                    except ValueError:
                        continue  # torn tail line
                    evt = doc.get("evt")
                    if evt == "span" and "dur_ms" in doc:
                        out["span"].append(doc)
                    elif evt == "edge" and "t_recv_us" in doc:
                        out["edge"].append(doc)
                    elif evt == "quorum" and "order" in doc:
                        out["quorum"].append(doc)
        except OSError:
            continue
    return out


def load_spans(paths: List[str]) -> List[dict]:
    """Span docs only (critical_path's entry point)."""
    return load_ledger(paths)["span"]


def discover(log_dir: str) -> List[str]:
    """Every span-ledger file a deployment flavor writes: one
    ``<id>.spans.jsonl`` per node process, or the bench/sim single
    ``spans.jsonl`` / ``sim.spans.jsonl``."""
    return sorted(
        set(glob.glob(os.path.join(log_dir, "*.spans.jsonl")))
        | set(glob.glob(os.path.join(log_dir, "spans.jsonl")))
    )


def pctile(sorted_vals: List[float], p: float) -> float:
    """Index-based percentile over an ascending list (the selection
    critical_path's band decomposition uses)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(p / 100.0 * len(sorted_vals))))
    return sorted_vals[i]
