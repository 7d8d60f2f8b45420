"""Per-metric readers, one file a metric (`<name>.py`, loaded by path).

Each file's `read(record)` takes a driver's record and returns the
metric's value, or None where the run gave it nothing to read (the
harness then leaves the metric out of the line). The arithmetic two
cells' variants of one quantity share lives here."""

from __future__ import annotations


def ratio(record: dict, num: str, den: str, scale: float = 1.0):
    if not record.get(den):
        return None
    return scale * record[num] / record[den]


def idle_share(record: dict):
    """Percent of the window in which no device interval ran, over the
    union of every traced process's device events."""
    if not record.get("traced_processes"):
        return None
    return 100.0 * (1.0 - record["device_busy_s"] / record["window_s"])


def host_prep_us(record: dict):
    """The `verify.host_prep` spans' time over the items they covered."""
    return ratio(record, "host_prep_ms", "host_prep_items", 1e3)


def items_per_pass(record: dict):
    return ratio(record, "pass_items", "passes")
