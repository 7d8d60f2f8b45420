"""Cross-replica causal trace plane: wire envelopes + quorum-arrival stats.

Every other instrument in the repo is per-process — ``spans.py`` tiles a
slot's latency at one node, wire accounting counts bytes per link.  This
module adds the committee-global view:

- ``stamp(raw, ...)`` splices an **unsigned** trace envelope into the
  canonical wire frame of a hot consensus message (pre-prepare, votes,
  QC certs, view-change traffic).  The envelope is a top-level ``"tr"``
  key inserted at its sorted position, so the frame stays canonical
  JSON; signatures cover the message *fields* (``Message._build`` drops
  unknown keys before payload reconstruction), so stamped and unstamped
  frames verify identically — no wire-compat or signature break.
- ``recv_stamp(node_id, raw)`` runs at each transport's delivery seam.
  The envelope carries the sender's send timestamp, so one recv-side
  ``{"evt":"edge"}`` ledger doc is a complete send/recv pair keyed on
  (view, seq, phase, src, dst).  ``tools/slot_trace.py`` joins these
  across all nodes' span ledgers into one causal DAG per slot.
- ``QuorumStats`` records per-certificate vote *arrival order* at the
  collecting replica: the arrival rank of each voter, and the margin
  between the (2f+1)-th vote and the slowest — the headroom before a
  straggler enters the quorum path.  In QC mode votes flow to the
  primary only, so arrival order is observable there alone (documented
  in docs/OBSERVABILITY.md).

Timestamps are ``int(clock.now() * 1e6)`` — virtual microseconds under
the sim clock (byte-deterministic across identical seeds), per-process
monotonic microseconds on real runs (independent epochs per node; the
skew solver in slot_trace recovers pairwise offsets from symmetric
message pairs, NTP-style).

The plane is OFF by default (``configure(True)`` to enable): production
hot paths and existing sim wire fingerprints are unchanged unless a run
opts in.  Every public entry point is never-raise — tracing must not be
able to take down consensus (pbftlint PBL004 audits the call sites).
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Tuple

from . import clock
from .logutil import Histogram

# Envelope phases stamped on the wire.  slot_trace classifies message
# edges by these names; keep in sync with docs/OBSERVABILITY.md.
PREPREPARE = "preprepare"
PREPARE = "prepare"
COMMIT = "commit"
QC_PREPARE = "qc-prepare"
QC_COMMIT = "qc-commit"
VIEWCHANGE = "viewchange"
NEWVIEW = "newview"

# Fast substring gate: a stamped frame always contains this byte run
# (canonical JSON — no whitespace), an unstamped one never does because
# "tr" is not a field name of any message type (checked in tests).
_GATE = b'"tr":{'

_enabled = False
_lock = threading.Lock()
# sender -> next span id.  Reset by configure() so two identical seeded
# runs in one process emit byte-identical ledgers.
_span_seq: Dict[str, int] = {}


def enabled() -> bool:
    """True when wire stamping is on for this process."""
    return _enabled


def configure(on: bool) -> None:
    """Enable/disable wire stamping and reset per-sender span counters."""
    global _enabled
    with _lock:
        _enabled = bool(on)
        _span_seq.clear()


def _next_span(sender: str) -> int:
    with _lock:
        i = _span_seq.get(sender, 0)
        _span_seq[sender] = i + 1
    return i


# ---------------------------------------------------------------------------
# Canonical-frame scanners.  These mirror transport.base._skip_string /
# _skip_value byte-for-byte; kept local so the import graph stays one
# direction (transports import trace, never the reverse).

def _skip_string(raw: bytes, i: int) -> int:
    # raw[i] == '"'; returns index just past the closing quote.
    i += 1
    n = len(raw)
    while i < n:
        c = raw[i]
        if c == 0x5C:  # backslash
            i += 2
            continue
        if c == 0x22:  # quote
            return i + 1
        i += 1
    raise ValueError("unterminated string")


def _skip_value(raw: bytes, i: int) -> int:
    # Returns index just past the JSON value starting at i.
    n = len(raw)
    c = raw[i]
    if c == 0x22:  # string
        return _skip_string(raw, i)
    if c in (0x7B, 0x5B):  # { or [
        depth = 0
        while i < n:
            c = raw[i]
            if c == 0x22:
                i = _skip_string(raw, i)
                continue
            if c in (0x7B, 0x5B):
                depth += 1
            elif c in (0x7D, 0x5D):
                depth -= 1
                if depth == 0:
                    return i + 1
            i += 1
        raise ValueError("unterminated container")
    # number / literal: scan to the next delimiter
    while i < n and raw[i] not in (0x2C, 0x7D, 0x5D):
        i += 1
    return i


def stamp(raw: bytes, phase: str, view: int, seq: int, sender: str) -> bytes:
    """Return ``raw`` with an unsigned trace envelope spliced in.

    No-op (returns ``raw`` unchanged) when the plane is disabled, the
    frame is already stamped, or anything at all goes wrong — a stamp
    failure must never cost a consensus message.
    """
    if not _enabled:
        return raw
    try:
        if _GATE in raw or not raw.startswith(b'{"'):
            return raw
        env = (
            b'"tr":{"i":%d,"p":"%s","q":%d,"s":"%s","t":%d,"v":%d}'
            % (
                _next_span(sender),
                phase.encode("ascii"),
                seq,
                sender.encode("ascii"),
                int(clock.now() * 1e6),
                view,
            )
        )
        return _splice(raw, env)
    except Exception:
        return raw


def _splice(raw: bytes, env: bytes) -> bytes:
    # Insert env at its sorted top-level key position so the frame stays
    # canonical (sorted keys, no whitespace).
    i = 1
    n = len(raw)
    while i < n and raw[i] == 0x22:
        j = _skip_string(raw, i)
        key = raw[i + 1 : j - 1]
        if key > b"tr":
            return raw[:i] + env + b"," + raw[i:]
        if raw[j : j + 1] != b":":
            return raw
        i = _skip_value(raw, j + 1)
        if raw[i : i + 1] != b",":
            # end of object: append before the closing brace
            return raw[:i] + b"," + env + raw[i:]
        i += 1
    return raw


def extract(raw: bytes) -> Optional[Dict[str, Any]]:
    """Parse the trace envelope out of a stamped frame, or None."""
    try:
        if _GATE not in raw or not raw.startswith(b'{"'):
            return None
        i = 1
        n = len(raw)
        seg: Optional[Tuple[int, int]] = None
        while i < n and raw[i] == 0x22:
            j = _skip_string(raw, i)
            key = raw[i + 1 : j - 1]
            if raw[j : j + 1] != b":":
                return None
            k = _skip_value(raw, j + 1)
            if key == b"tr":
                seg = (j + 1, k)
                break
            if key > b"tr":
                return None
            if raw[k : k + 1] != b",":
                return None
            i = k + 1
        if seg is None:
            return None
        env = json.loads(raw[seg[0] : seg[1]])
        if (
            isinstance(env, dict)
            and isinstance(env.get("p"), str)
            and isinstance(env.get("s"), str)
            and isinstance(env.get("t"), int)
            and isinstance(env.get("v"), int)
            and isinstance(env.get("q"), int)
        ):
            return env
        return None
    except Exception:
        return None


def recv_stamp(node_id: str, raw: bytes) -> None:
    """Record one cross-node edge doc for a stamped inbound frame.

    Called at every transport's delivery seam, after queue residency
    (so the recv timestamp includes injected fault delay and queue
    wait).  Self-delivered frames and unstamped frames are free: the
    substring gate rejects them before any parsing.  Never raises.
    """
    try:
        if _GATE not in raw:
            return
        env = extract(raw)
        if env is None or env["s"] == node_id:
            return
        from . import spans

        spans.emit(
            {
                "evt": "edge",
                "phase": env["p"],
                "view": env["v"],
                "seq": env["q"],
                "src": env["s"],
                "node": node_id,
                "span": env.get("i", 0),
                "t_send_us": env["t"],
                "t_recv_us": int(clock.now() * 1e6),
            }
        )
    except Exception:
        pass


# ---------------------------------------------------------------------------
# Quorum-arrival order statistics


class QuorumStats:
    """Per-certificate vote-arrival order at the collecting replica.

    ``note_vote`` is called at decode time in the ingest sweep —
    *before* verification and before the redundant-vote precheck, which
    is the whole point: post-quorum stragglers are dropped there and
    never reach the state machine, but their arrival time is exactly
    the headroom number we want.  First arrival per (cert, sender)
    wins; sender ids are unverified at that point, so the table is
    bounded (``MAX_OPEN`` certs, committee-sized voter maps).

    A certificate finalizes when the quorum has been marked
    (``note_quorum`` from the SendCommit / ExecuteBlock transitions)
    and either every committee member's vote has arrived or the slot is
    garbage-collected past the stable watermark (``flush_upto``).
    Finalizing emits one ``{"evt":"quorum"}`` ledger doc with the full
    arrival order, the (2f+1)-th-vs-slowest margin, and the straggler
    id, and feeds the live margin histogram surfaced via telemetry.

    All methods are never-raise (pbftlint PBL004 audited).
    """

    MAX_OPEN = 4096

    def __init__(self, node_id: str) -> None:
        self.node_id = node_id
        self.margin_ms = Histogram()
        self.straggler_counts: Dict[str, int] = {}
        self.last_margin_ms = 0.0
        self.last_straggler = ""
        self.certs_finalized = 0
        self.certs_partial = 0
        # (view, seq, phase) -> {"arr": {sender: t}, "q": quorum, "n": committee, "tq": t_quorum}
        self._open: Dict[Tuple[int, int, str], Dict[str, Any]] = {}

    def _rec(self, view: int, seq: int, phase: str) -> Optional[Dict[str, Any]]:
        key = (view, seq, phase)
        rec = self._open.get(key)
        if rec is None:
            if len(self._open) >= self.MAX_OPEN:
                return None
            rec = self._open[key] = {"arr": {}, "q": 0, "n": 0, "tq": None}
        return rec

    def note_vote(self, phase: str, view: int, seq: int, sender: str) -> None:
        """Record a vote arrival (first arrival per sender wins)."""
        try:
            rec = self._rec(view, seq, phase)
            if rec is None or sender in rec["arr"]:
                return
            rec["arr"][sender] = clock.now()
            if rec["tq"] is not None and rec["n"] and len(rec["arr"]) >= rec["n"]:
                self._finalize((view, seq, phase), rec)
        except Exception:
            pass

    def note_quorum(self, phase: str, view: int, seq: int, quorum: int, n: int) -> None:
        """Mark that the certificate reached quorum (2f+1 valid votes)."""
        try:
            rec = self._rec(view, seq, phase)
            if rec is None or rec["tq"] is not None:
                return
            rec["q"] = quorum
            rec["n"] = n
            rec["tq"] = clock.now()
            if len(rec["arr"]) >= n:
                self._finalize((view, seq, phase), rec)
        except Exception:
            pass

    def flush_upto(self, stable_seq: int) -> None:
        """Finalize and drop every open certificate at or below the watermark."""
        try:
            for key in sorted(k for k in self._open if k[1] <= stable_seq):
                self._finalize(key, self._open[key])
        except Exception:
            pass

    def flush_all(self) -> None:
        """Finalize everything still open (end of run)."""
        try:
            for key in sorted(self._open):
                self._finalize(key, self._open[key])
        except Exception:
            pass

    def _finalize(self, key: Tuple[int, int, str], rec: Dict[str, Any]) -> None:
        self._open.pop(key, None)
        quorum = rec["q"]
        arr = rec["arr"]
        if rec["tq"] is None or quorum <= 0 or len(arr) < quorum:
            # Never reached quorum locally (e.g. QC-mode backup: shares
            # flow to the primary only) — nothing to attribute.
            self.certs_partial += 1
            return
        order = sorted(arr, key=lambda s: (arr[s], s))
        t_q = arr[order[quorum - 1]]
        t_slow = arr[order[-1]]
        margin_ms = round((t_slow - t_q) * 1e3, 4)
        straggler = order[-1]
        self.certs_finalized += 1
        self.margin_ms.record(margin_ms)
        self.straggler_counts[straggler] = self.straggler_counts.get(straggler, 0) + 1
        self.last_margin_ms = margin_ms
        self.last_straggler = straggler
        from . import spans

        spans.emit(
            {
                "evt": "quorum",
                "node": self.node_id,
                "phase": key[2],
                "view": key[0],
                "seq": key[1],
                "quorum": quorum,
                "votes": len(arr),
                "t_quorum_us": int(rec["tq"] * 1e6),
                "margin_ms": margin_ms,
                "straggler": straggler,
                "order": order,
            }
        )

    def snapshot(self) -> Dict[str, Any]:
        """Live quorum block for the telemetry snapshot / pbft_top."""
        try:
            top: List[Tuple[str, int]] = sorted(
                self.straggler_counts.items(), key=lambda kv: (-kv[1], kv[0])
            )[:3]
            return {
                "certs": self.certs_finalized,
                "partial": self.certs_partial,
                "open": len(self._open),
                "margin_ms": self.margin_ms.summary(),
                "last_margin_ms": self.last_margin_ms,
                "last_straggler": self.last_straggler,
                "stragglers": {k: v for k, v in top},
            }
        except Exception:
            return {"certs": 0, "partial": 0, "open": 0}
