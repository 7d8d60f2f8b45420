"""Pluggable application (execution) layer.

The reference never executes anything: commit sets ``result = "Executed"``
(a literal string, pbft_impl.go:158) and drops the operation. Here
execution is a real seam: committed blocks are applied in sequence order to
an ``Application``, whose state digest feeds checkpoint messages, and whose
snapshot/restore pair supports state transfer to lagging replicas.

The speculative seam: :class:`ForkableApp` holds a
disposable FORK of the committed state that prepared-but-uncommitted
blocks execute against (Proof-of-Execution-style speculation,
consensus/speculation.py). The committed surface — ``apply`` /
``snapshot`` / ``state_digest`` / ``restore`` — always reflects ONLY
finally-committed execution, so checkpoint digests can never absorb
speculative writes; the fork is a separate object built from (and
discarded back to) the committed snapshot.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, FrozenSet, Optional, Protocol, Tuple


class Application(Protocol):
    def apply(self, op: str) -> str:
        """Execute one operation, return its result string."""
        ...

    def state_digest(self) -> str:
        """Digest of current state (checkpoint identity). Must equal
        sha256(snapshot()) so snapshots are verifiable against checkpoint
        certificates."""
        ...

    def snapshot(self) -> str:
        """Serialize full state (state-transfer payload)."""
        ...

    def restore(self, snap: str) -> None:
        """Replace state with a snapshot."""
        ...


def snapshot_digest(snap: str) -> str:
    return hashlib.sha256(snap.encode()).hexdigest()


class EchoApp:
    """Reference-parity app: every operation 'executes' to a fixed string
    (mirrors pbft_impl.go:158)."""

    def apply(self, op: str) -> str:
        return "Executed"

    def snapshot(self) -> str:
        return ""

    def restore(self, snap: str) -> None:
        pass

    def state_digest(self) -> str:
        return snapshot_digest("")


class KVStore:
    """Tiny ordered key-value store: ``put k v`` / ``get k`` / ``noop``.

    Deterministic across replicas (a requirement the reference never faced,
    having no execution). The state digest is the hash of the canonical
    snapshot, so a lagging replica can verify a transferred snapshot
    against a 2f+1 checkpoint certificate.
    """

    def __init__(self) -> None:
        self.data: Dict[str, str] = {}

    def apply(self, op: str) -> str:
        parts = op.split(" ")
        if parts[0] == "put" and len(parts) >= 3:
            key, value = parts[1], " ".join(parts[2:])
            self.data[key] = value
            return "ok"
        if parts[0] == "get" and len(parts) == 2:
            return self.data.get(parts[1], "")
        if parts[0] == "noop":
            return "ok"
        return "err:bad-op"

    def snapshot(self) -> str:
        return json.dumps(self.data, sort_keys=True, separators=(",", ":"))

    def restore(self, snap: str) -> None:
        data = json.loads(snap)
        if not isinstance(data, dict) or not all(
            isinstance(k, str) and isinstance(v, str) for k, v in data.items()
        ):
            raise ValueError("bad snapshot")
        self.data = data

    def state_digest(self) -> str:
        return snapshot_digest(self.snapshot())

    def rw_sets(
        self, op: str
    ) -> Optional[Tuple[FrozenSet[str], FrozenSet[str]]]:
        """(reads, writes) key sets of one operation, or None when the
        op is unparsable. Out-of-order speculation (consensus/
        speculation.py) uses this to prove a later slot commutes with a
        committed-but-unapplied gap; None disables that fast path for
        the op — never a wrong answer."""
        parts = op.split(" ")
        if parts[0] == "put" and len(parts) >= 3:
            return frozenset(), frozenset([parts[1]])
        if parts[0] == "get" and len(parts) == 2:
            return frozenset([parts[1]]), frozenset()
        if parts[0] == "noop":
            return frozenset(), frozenset()
        return None


class ForkableApp:
    """Committed application + a disposable speculative fork.

    The Application protocol surface (``apply``/``snapshot``/``restore``/
    ``state_digest``) delegates to the COMMITTED inner app only — by
    construction a checkpoint snapshot cut through this wrapper can never
    contain speculative writes (the speculation safety invariant). The fork
    is a second instance of the same Application class, (re)built from
    the committed snapshot on first speculative apply after a rollback,
    and kept in lockstep thereafter: confirmed slots apply to BOTH
    states (the fork via ``apply_spec`` at prepare time, the committed
    app via ``apply`` at commit time), so in honest runs the two digests
    converge whenever speculation drains.

    Unknown attributes delegate to the inner app (``r.app.data`` etc.
    keep working for tests and tools)."""

    def __init__(self, inner: Application) -> None:
        self.inner = inner
        self._fork: Optional[Application] = None
        self.forks_built = 0

    # -- Application protocol: committed state only ---------------------

    def apply(self, op: str) -> str:
        return self.inner.apply(op)

    def snapshot(self) -> str:
        return self.inner.snapshot()

    def restore(self, snap: str) -> None:
        self.inner.restore(snap)
        # the committed anchor moved under the fork (state transfer):
        # every speculative write built on the old anchor is void
        self._fork = None

    def state_digest(self) -> str:
        return self.inner.state_digest()

    # -- speculative fork ----------------------------------------------

    def forkable(self) -> bool:
        """Can a fork be built? Needs a zero-arg-constructible app class
        with snapshot/restore — checked once, cheaply, not assumed."""
        try:
            probe = type(self.inner)()
            probe.restore(self.inner.snapshot())
            return True
        except Exception:  # noqa: BLE001 — any failure: speculation off
            return False

    def _ensure_fork(self) -> Application:
        if self._fork is None:
            fork = type(self.inner)()
            fork.restore(self.inner.snapshot())
            self._fork = fork
            self.forks_built += 1
        return self._fork

    def apply_spec(self, op: str) -> str:
        """Execute one operation on the speculative fork (building it
        from the committed snapshot if none is open)."""
        return self._ensure_fork().apply(op)

    def spec_digest(self) -> Optional[str]:
        return self._fork.state_digest() if self._fork is not None else None

    def spec_open(self) -> bool:
        return self._fork is not None

    def rollback(self) -> None:
        """Discard the fork: speculative state walks back to the
        committed anchor. O(1) — the next apply_spec re-clones."""
        self._fork = None

    def rw_sets(self, op: str):
        fn = getattr(self.inner, "rw_sets", None)
        return fn(op) if callable(fn) else None

    def __getattr__(self, name):
        return getattr(self.inner, name)
