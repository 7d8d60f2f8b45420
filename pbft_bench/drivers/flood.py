"""The flood driver: closed loops of signed sweeps into the program's
verify service, with the consensus plane bypassed.

One process a replica (layout `process_per_replica`, as `launch.py`
deploys a committee on one host) or one process for the committee
(`shared_service`, as `bench_consensus` builds it). Each process builds
its verifier as the deployment does (`node.make_verifier("gpu", dep)`,
or `bench_consensus`'s shared one), with the configuration's fixed CPU
cutoff, and keeps `outstanding_items` items in flight: it submits a
sweep whenever an answer comes back, and judges every answer against
the verdict the pool was made with.

The parent process loads no torch and no program: it spawns the
processes, makes the run's signed messages while they start, opens and
closes the window for all at one instant, and joins their records.
"""

from __future__ import annotations

import gc
import multiprocessing
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from collections import deque

import numpy as np

from .. import controls, pool
from ..harness import NoCard, forbidden_modules, judge
from . import common

SETUP_TIMEOUT_S = 1100  # a checkout's first run builds every kernel
LATE_S = 60  # an answer due in the window may come this late


def _rehearsal(cfg: dict, traffic: dict, cell: dict):
    """The tests' CPU rehearsal: two processes, a few sweeps."""
    sweep = 2 * cfg["n"] - 1
    cfg = dict(cfg, processes=min(cfg["processes"], 2))
    traffic = dict(traffic, pool_items=6 * sweep, outstanding_items=2 * sweep,
                   corrupt_one_in=8)
    cell = dict(cell, warm_s=0.2, reference_sample=4)
    return cfg, traffic, cell


def run(spec, seed: int, seconds: float, trace: bool, control, t_start: float,
        rehearse: bool = False) -> dict:
    cfg, traffic, cell = spec.config, spec.traffic, spec.cell
    if rehearse:
        cfg, traffic, cell = _rehearsal(cfg, traffic, cell)
    if control is not None and control not in controls.FLOOD:
        raise SystemExit(f"{control!r} is not a flood control")
    os.environ.update(cfg["env"])  # before the processes start
    ctx = multiprocessing.get_context("spawn")
    job = {"config": cfg, "traffic": traffic, "cell": cell, "chips": spec.chips,
           "seed": seed, "trace": trace, "control": control, "rehearse": rehearse}
    tmp = tempfile.mkdtemp(prefix="pbft_bench_")
    procs, conns = [], []
    ok = False
    try:
        for rank in range(cfg["processes"]):
            mine, theirs = ctx.Pipe()
            p = ctx.Process(target=child_main, args=(theirs, job, rank), daemon=True)
            p.start()
            theirs.close()
            procs.append(p)
            conns.append(mine)
        rnd = pool.Round(cfg, seed, pool.sweep_count(cfg, traffic))
        path = os.path.join(tmp, "round.pkl")
        with open(path, "wb") as fh:
            pickle.dump(rnd, fh, protocol=pickle.HIGHEST_PROTOCOL)
        del rnd
        for c in conns:
            c.send(path)
        infos = [_recv(c, SETUP_TIMEOUT_S) for c in conns]
        w0 = time.monotonic() + 0.25
        w1 = w0 + seconds
        for c in conns:
            c.send((w0, w1))
        recs = [_recv(c, seconds + LATE_S + 240) for c in conns]
        ok = True
    finally:
        for p in procs:
            p.join(timeout=30 if ok else 0)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return _aggregate(recs, infos, w0, w1, t_start, trace)


def _recv(conn, timeout: float):
    if not conn.poll(timeout):
        raise RuntimeError(f"a flood process sent nothing in {timeout:.0f} s")
    kind, body = conn.recv()
    if kind == "nocard":
        raise NoCard(body)
    if kind == "error":
        raise RuntimeError("a flood process failed:\n" + body)
    return body


def _aggregate(recs, infos, w0, w1, t_start, trace) -> dict:
    window = w1 - w0
    info = infos[0]
    checks = {
        "wrong_verdicts": {"value": sum(r["wrong"] for r in recs), "limit": 0},
        "missing_answers": {"value": sum(r["missing"] for r in recs), "limit": 0},
        "reference_mismatches": {"value": sum(r["ref_mismatches"] for r in recs), "limit": 0},
    }
    rec = {
        "correct": judge(checks),
        "attempted": sum(r["attempted"] for r in recs),
        "failed": sum(r["wrong"] + r["missing"] for r in recs),
        "checks": checks,
        "device": {"platform": info["platform"], "kind": info["kind"], "count": 1,
                   "memory_peak_bytes": max(r["memory_bytes"] for r in recs)},
        "setup_s": w0 - t_start,
        "window_s": window,
        "processes": len(recs),
        "verifies": sum(r["done"] for r in recs),
        "passes": sum(r["passes"] for r in recs),
        "pass_items": sum(r["pass_items"] for r in recs),
        "host_prep_ms": sum(r["host_prep_ms"] for r in recs),
        "host_prep_items": sum(r["host_prep_items"] for r in recs),
        "forbidden_modules": sorted({m for r in recs for m in r["forbidden"]}),
        "reference_sample": sum(r["ref_sample"] for r in recs),
        # when the last process finished each step of its set-up
        "setup_steps_s": {k: max(i["stamps"][k] for i in infos) - t_start
                          for k in infos[0]["stamps"]},
    }
    if trace:
        rec.update(common.join_traces([r["trace"] for r in recs], window, "service_and_loop"))
        rec["device"]["busy_s"] = rec["device_busy_s"]
        rec["device"]["window_s"] = window
    return rec


# --------------------------------------------------------------------------
# one flood process
# --------------------------------------------------------------------------


def child_main(conn, job: dict, rank: int) -> None:
    try:
        conn.send(("done", _child(conn, job, rank)))
    except NoCard as e:
        conn.send(("nocard", str(e)))
    except BaseException:  # noqa: BLE001 -- reported to the parent, which fails the run
        conn.send(("error", f"process {rank}:\n{traceback.format_exc()}"))
        sys.exit(1)
    finally:
        conn.close()


class _Loop:
    """A closed loop of sweeps through the service, judging every answer."""

    def __init__(self, svc, sweeps, verdicts, target: int, watch=()):
        self.svc, self.sweeps, self.verdicts, self.target = svc, sweeps, verdicts, target
        self.watch = set(watch)
        self.seen = {}
        self.out = deque()
        self.pending = 0
        self.next = 0
        self.reset()

    def reset(self) -> None:
        self.done = self.judged = self.wrong = self.missing = 0

    def _judge(self, j: int, v) -> None:
        want = self.verdicts[j]
        self.judged += len(want)
        if v != want:
            self.wrong += sum(a != b for a, b in zip(v, want)) + abs(len(v) - len(want))
        if j in self.watch:
            self.seen[j] = v

    def drive(self, stop_at: float) -> None:
        """Keep `target` items in flight until an answer comes at or after
        `stop_at`; answers before it count as done."""
        svc, sweeps, out = self.svc, self.sweeps, self.out
        last = len(sweeps) - 1
        while True:
            while self.pending < self.target:
                j = self.next
                out.append((svc.submit(sweeps[j]), j))
                self.pending += len(sweeps[j])
                self.next = j + 1 if j < last else 0
            fut, j = out.popleft()
            self.pending -= len(sweeps[j])
            try:
                v = fut.result()
            except Exception:  # noqa: BLE001 -- an answer that failed is a missing answer
                self.missing += len(sweeps[j])
                v = None
            if v is not None:
                self._judge(j, v)
            if time.monotonic() >= stop_at:
                return
            if v is not None:
                self.done += len(sweeps[j])

    def drain(self, deadline: float) -> None:
        """Wait for every answer still in flight, until `deadline`."""
        while self.out:
            fut, j = self.out.popleft()
            self.pending -= len(self.sweeps[j])
            try:
                self._judge(j, fut.result(timeout=max(0.0, deadline - time.monotonic())))
            except Exception:  # noqa: BLE001 -- late past the deadline, or failed: missing
                self.missing += len(self.sweeps[j])


def _child(conn, job: dict, rank: int) -> dict:
    cfg, traffic, cell, seed = job["config"], job["traffic"], job["cell"], job["seed"]
    stamps = {}
    torch, device = common.open_device(job["chips"], job["rehearse"])
    stamps["torch"] = time.monotonic()
    torch.set_num_threads(cfg["torch_threads"])
    from simple_pbft_tpu_torch.crypto.coalesce import VerifyService
    from simple_pbft_tpu_torch.crypto.gpu_verifier import GpuVerifier
    from simple_pbft_tpu_torch.crypto.verifier import BatchItem

    with open(conn.recv(), "rb") as fh:
        rnd = pickle.load(fh)
    pubs = list(rnd.pub.values())
    v = cfg["verifier"]
    verifier = GpuVerifier(device=device, mode=v["mode"], window=v["window"],
                           initial_keys=len(pubs) + v["initial_keys_extra"])
    svc = VerifyService(verifier, max_pending=v["max_pending"], cpu_cutoff=v["cpu_cutoff"],
                        dispatch_deadline=v["dispatch_deadline_s"])
    stamps["verifier"] = time.monotonic()
    svc.warm_for_population(pubs, max_sweep=v["max_sweep"])
    stamps["bank_and_warm"] = time.monotonic()
    fp = pool.flood_pool(rnd, cfg, traffic, seed, rank)
    del rnd
    sweeps = [[BatchItem(*t) for t in sw] for sw in fp.sweeps]
    rng = np.random.default_rng([seed % (1 << 63), rank, 8032])
    half = cell["reference_sample"] // 2
    bad = sorted(fp.kinds)
    good = [(s, p) for s in rng.choice(len(sweeps), size=4 * half)
            for p in [int(rng.integers(len(sweeps[s])))] if (int(s), p) not in fp.kinds][:half]
    sample = [bad[int(i)] for i in rng.choice(len(bad), size=min(half, len(bad)), replace=False)]
    sample += [(int(s), p) for s, p in good]
    if job["control"]:
        controls.patch_service(job["control"], svc, verifier)
    loop = _Loop(svc, sweeps, fp.verdicts, traffic["outstanding_items"], {s for s, _ in sample})
    stamps["pool"] = time.monotonic()
    # the pipeline's first passes, before the window
    loop.drive(time.monotonic() + cell["warm_s"])
    loop.drain(time.monotonic() + LATE_S)
    loop.reset()
    loop.seen.clear()
    facts = common.device_facts(torch, device)
    hooks = None
    if job["trace"]:
        flat = [it for sw in sweeps for it in sw]
        hooks = common.TraceHooks(verifier, flat, {pk: k for k, pk in enumerate(pubs)})
    gc.collect()
    gc.freeze()  # the pool and the program's set-up are never walked again
    stamps["load_before_window"] = time.monotonic()
    conn.send(("ready", dict(facts, stamps=stamps)))
    w0, w1 = conn.recv()
    common.sleep_until(w0)
    c0 = common.service_counters(svc)
    loop.drive(w1)
    c1 = common.service_counters(svc)
    memory = common.card_memory_used(torch, device)
    loop.drain(time.monotonic() + LATE_S)
    traced = None
    if hooks is not None:
        traced = hooks.stop(w0, w1, facts["sms"])
    svc.close()
    answers = [loop.seen[s][p] for s, p in sample if s in loop.seen]
    items = [fp.sweeps[s][p] for s, p in sample if s in loop.seen]
    return {
        "done": loop.done, "attempted": loop.judged + loop.missing,
        "wrong": loop.wrong, "missing": loop.missing,
        "ref_mismatches": common.reference_mismatches(items, answers),
        "ref_sample": len(items),
        "passes": c1["passes"] - c0["passes"],
        "pass_items": c1["pass_items"] - c0["pass_items"],
        "host_prep_ms": c1["prep_ms"] - c0["prep_ms"],
        "host_prep_items": c1["pass_items"] - c0["pass_items"],
        "memory_bytes": memory,
        "forbidden": forbidden_modules(),
        "trace": traced,
    }
