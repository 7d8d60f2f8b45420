"""Injectable clock seam.

Every TIMER DECISION in the clock-injectable modules — replica view/
retransmit/cooldown deadlines, client backoff and request timestamps,
the statesync retry tick, telemetry watchdogs, the fault injector's
event offsets — goes through this module instead of reading the OS
clock directly:

- ``clock.now()``     instead of ``time.monotonic()``/``perf_counter()``
- ``clock.sleep(d)``  instead of ``asyncio.sleep(d)``
- ``clock.timestamp_us()`` instead of ``int(time.time() * 1e6)``
- ``clock.off_thread(fn, *a)`` instead of ``asyncio.to_thread(fn, *a)``

In wall mode (the default, and the only mode real deployments run) the
four are thin aliases with identical behavior. Under simulation
(simple_pbft_tpu/sim.py installs a :class:`SimClock`) ``now()`` reads
the SimLoop's VIRTUAL time — which jumps to the next scheduled event
instead of sleeping — ``timestamp_us()`` derives request timestamps
from virtual time against a fixed epoch (bit-identical traces run to
run), and ``off_thread`` runs the work inline on the loop, because a
real worker thread completes in wall time and would race virtual time
nondeterministically.

Timers scheduled directly on the event loop (``loop.call_later``,
``loop.call_at``, ``asyncio.wait_for``) need no seam: they already key
on ``loop.time()``, which the SimLoop virtualizes wholesale. The seam
exists for the OTHER clock reads — deadline/cooldown comparisons held
in plain floats — which would silently freeze (cooldowns never expire)
or starve (deadlines never arrive) if they stayed on the wall clock
while the loop's time compressed.

pbftlint PBL007 enforces the contract: raw ``time.monotonic()`` /
``time.perf_counter()`` / ``time.time()`` / ``asyncio.sleep()`` /
``loop.time()`` in a clock-injectable module is a finding unless a
justified suppression names why that site is exempt.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Callable


class WallClock:
    """The default: real monotonic time, real sleeps, real threads."""

    simulated = False

    def now(self) -> float:
        return time.monotonic()

    def timestamp_us(self) -> int:
        # wall-derived (Castro-Liskov §2.4): client request timestamps
        # must be monotonic ACROSS process restarts — see client.py
        return int(time.time() * 1_000_000)

    async def sleep(self, delay: float) -> None:
        await asyncio.sleep(delay)

    async def off_thread(self, fn: Callable, *args: Any) -> Any:
        return await asyncio.to_thread(fn, *args)


class SimClock:
    """Virtual clock bound to a SimLoop (simple_pbft_tpu/sim.py).

    ``now()`` is the loop's virtual time, so deadline math in product
    code and the loop's own timers share one timebase. Request
    timestamps derive from virtual time against a FIXED epoch: the same
    scenario seed replays byte-identical wire traffic, and a "restart"
    within one simulation stays monotonic because virtual time does.
    """

    simulated = True

    # deterministic wall anchor for timestamp_us (an arbitrary constant;
    # only monotonicity and reproducibility matter inside a simulation)
    SIM_WALL_EPOCH_US = 1_700_000_000_000_000

    def __init__(self, loop: asyncio.AbstractEventLoop) -> None:
        self._loop = loop

    def now(self) -> float:
        return self._loop.time()

    def timestamp_us(self) -> int:
        return self.SIM_WALL_EPOCH_US + int(self._loop.time() * 1_000_000)

    async def sleep(self, delay: float) -> None:
        # plain asyncio.sleep: the SimLoop virtualizes loop timers, so
        # this parks on a virtual deadline, not a wall one
        await asyncio.sleep(delay)

    async def off_thread(self, fn: Callable, *args: Any) -> Any:
        # inline: a worker thread finishes in WALL time, which under a
        # compressed virtual clock is "arbitrarily late" — every
        # interleaving downstream of it would be a race against however
        # far virtual time happened to jump meanwhile. Simulation trades
        # loop-blocking (harmless: nothing real-time shares the loop)
        # for determinism.
        return fn(*args)


_WALL = WallClock()
_active: Any = _WALL


def get() -> Any:
    return _active


def simulated() -> bool:
    return bool(_active.simulated)


def install(c: Any) -> Any:
    """Install a clock; returns the previous one (callers restore it in
    a finally — sim_run does)."""
    global _active
    prev = _active
    _active = c
    return prev


def reset() -> None:
    global _active
    _active = _WALL


def now() -> float:
    return _active.now()


def timestamp_us() -> int:
    return _active.timestamp_us()


async def sleep(delay: float) -> None:
    await _active.sleep(delay)


async def off_thread(fn: Callable, *args: Any) -> Any:
    return await _active.off_thread(fn, *args)
