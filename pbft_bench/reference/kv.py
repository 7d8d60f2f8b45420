"""The key-value store's semantics in plain Python: what a committee's
state and replies must be once its committed requests are applied.
Imports nothing of the program."""

from __future__ import annotations

from typing import Dict


class KV:
    def __init__(self) -> None:
        self.data: Dict[str, str] = {}

    def apply(self, op: str) -> str:
        parts = op.split(" ")
        if parts[0] == "put" and len(parts) >= 3:
            self.data[parts[1]] = " ".join(parts[2:])
            return "ok"
        if parts[0] == "get" and len(parts) == 2:
            return self.data.get(parts[1], "")
        if parts[0] == "noop":
            return "ok"
        return "err:bad-op"


def state_mismatches(want: Dict[str, str], got: Dict[str, str], either=None) -> int:
    """Keys whose value differs between the reference's state and a
    replica's, counting keys only one of them holds. `either` maps a key
    to a second value it may hold (a put whose acknowledgement never came
    may or may not have committed)."""
    either = either or {}
    bad = 0
    for key in set(want) | set(got):
        if got.get(key) != want.get(key) and got.get(key) != either.get(key, object()):
            bad += 1
    return bad
