"""The committee driver: clients' requests through the program's
in-process committee, in closed loops.

The committee is built as `bench_consensus` builds its clean runs
(`LocalCommittee` on the in-process transport, no message delay, one
GpuVerifier behind one VerifyService shared by every replica, warmed to
every bucket), with its keys made from the seed. Each client runs
`in_flight_per_client` closed loops of KV puts. After every
`forged_one_in`-th request the loops send, the loop that sent it also
sends a request in its client's name whose signature is broken, which a
committee that verifies every message never executes. Load runs
`warm_s` before the window, and the requests still in flight when it
closes are waited for and judged.

After the window the committee settles, and the check compares every
replica's store with the reference's store of the acknowledged puts
(each loop owns its keys, so their order is the loop's) and every
acknowledged reply with the reference's answer.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import time
from typing import Dict, List

from .. import controls, pool
from ..harness import forbidden_modules, judge
from ..reference.kv import KV, state_mismatches
from . import common

LATE_S = 60  # an answer due in the window may come this late
SETTLE_S = 60  # replicas then finish executing what was proposed
FORGED_TS = 1 << 40  # forged requests' timestamps, far past a client's own


def _rehearsal(cfg: dict, traffic: dict, cell: dict):
    """The tests' CPU rehearsal: four replicas, two clients."""
    cfg = dict(cfg, n=4, f=1, clients=2,
               verifier=dict(cfg["verifier"], max_sweep=32))
    traffic = dict(traffic, in_flight_per_client=2, forged_one_in=4)
    return cfg, traffic, dict(cell, warm_s=1.0)


def run(spec, seed: int, seconds: float, trace: bool, control, t_start: float,
        rehearse: bool = False) -> dict:
    cfg, traffic, cell = spec.config, spec.traffic, spec.cell
    if rehearse:
        cfg, traffic, cell = _rehearsal(cfg, traffic, cell)
    if control is not None and control not in controls.COMMITTEE:
        raise SystemExit(f"{control!r} is not a committee control")
    os.environ.update(cfg["env"])
    torch, device = common.open_device(spec.chips, rehearse)
    torch.set_num_threads(cfg["torch_threads"])
    return asyncio.run(_run(cfg, traffic, cell, seed, seconds, trace, control,
                            t_start, torch, device))


def _lag_gauge():
    from simple_pbft_tpu_torch.telemetry import LoopLagGauge

    class SummingLag(LoopLagGauge):
        """The committee's loop-lag gauge, its samples also summed, so
        that a window's mean can be taken (the gauge keeps an EMA)."""

        sum_ms = 0.0

        @property
        def last_ms(self) -> float:
            return self._last

        @last_ms.setter
        def last_ms(self, v: float) -> None:
            self._last = v
            self.sum_ms += v

    return SummingLag(interval=0.1)


def _build(cfg: dict, traffic: dict, seed: int, device: str, control):
    from simple_pbft_tpu_torch.client import Client
    from simple_pbft_tpu_torch.committee import LocalCommittee
    from simple_pbft_tpu_torch.config import CommitteeConfig, KeyPair
    from simple_pbft_tpu_torch.consensus.replica import Replica
    from simple_pbft_tpu_torch.crypto import mac
    from simple_pbft_tpu_torch.crypto.coalesce import VerifyService
    from simple_pbft_tpu_torch.crypto.gpu_verifier import GpuVerifier
    from simple_pbft_tpu_torch.crypto.verifier import InsecureVerifier
    from simple_pbft_tpu_torch.transport.local import LocalNetwork

    replicas, clients = pool.names(cfg)
    keys = {nm: KeyPair.generate(pool.key_seed(seed, nm)) for nm in replicas + clients}
    c = cfg["committee"]
    conf = CommitteeConfig(
        replica_ids=tuple(replicas), pubkeys={k: v.pub for k, v in keys.items()},
        admin_ids=tuple(clients),
        kx_pubkeys={k: kx for k, v in keys.items() if (kx := mac.kx_pubkey(v.seed)) is not None},
        view_timeout=c["view_timeout_s"], checkpoint_interval=c["checkpoint_interval"],
        watermark_window=c["watermark_window"], max_batch=c["max_batch"],
        speculative=c["speculative"])
    v = cfg["verifier"]
    verifier = GpuVerifier(device=device, mode=v["mode"], window=v["window"],
                           initial_keys=len(keys) + v["initial_keys_extra"])
    svc = VerifyService(verifier, max_pending=v["max_pending"], cpu_cutoff=v["cpu_cutoff"],
                        dispatch_deadline=v["dispatch_deadline_s"])
    seat = InsecureVerifier() if control == "insecure" else svc
    net = LocalNetwork(None)
    com = LocalCommittee(cfg=conf, keys=keys, net=net)
    for rid in replicas:
        com.replicas.append(Replica(node_id=rid, cfg=conf, seed=keys[rid].seed,
                                    transport=net.endpoint(rid), verifier=seat,
                                    ahead_buffer=c["ahead_buffer"]))
    for cid in clients:
        cl = Client(client_id=cid, cfg=conf, seed=keys[cid].seed, transport=net.endpoint(cid))
        cl.request_timeout = traffic["request_timeout_s"]
        com.clients.append(cl)
    verifier.warm_for_population([k.pub for k in keys.values()], max_sweep=v["max_sweep"])
    return com, verifier, svc


class _Load:
    """Every client's closed loops and what they saw."""

    def __init__(self, com, traffic: dict, seed: int):
        self.com, self.traffic, self.seed = com, traffic, seed
        self.acked: List[tuple] = []  # (key, op, result, t_send, t_ack)
        self.failed: Dict[str, str] = {}  # key -> op whose answer never came
        self.forged = set()
        self.sent = 0  # requests sent by every loop, for the forged ones' pace
        self.stop_at = float("inf")

    async def _forge(self, client, k: int) -> None:
        from simple_pbft_tpu_torch.messages import Request

        key = f"f.{k}"
        self.forged.add(key)
        req = Request(client_id=client.id, timestamp=FORGED_TS + k,
                      operation=f"put {key} forged", ack=0)
        req.sender = client.id
        sig = bytearray(client.signer.sign(req.signing_payload()))
        sig[40] ^= 1  # S altered: no valid signature of this request
        req.sig = bytes(sig).hex()
        await client.transport.send(self.com.cfg.primary(0), req.to_wire())

    async def loop(self, client, ci: int, p: int) -> None:
        from simple_pbft_tpu_torch.client import SupersededError

        retries = max(3, client.retries_for_patience(75.0))
        per, forged_every = self.traffic["keys_per_pump"], self.traffic["forged_one_in"]
        i = 0
        while time.monotonic() < self.stop_at:
            op = pool.put_op(self.seed, ci, f"{p}.{i % per}", i)
            key = op.split(" ")[1]
            t0 = time.monotonic()
            try:
                res = await client.submit(op, retries=retries)
            except (asyncio.TimeoutError, TimeoutError, SupersededError):
                self.failed[key] = op
            else:
                self.acked.append((key, op, res, t0, time.monotonic()))
                self.failed.pop(key, None)
            self.sent += 1
            if forged_every and self.sent % forged_every == 0:
                await self._forge(client, self.sent // forged_every)
            i += 1

    def start(self) -> List[asyncio.Task]:
        per = self.traffic["in_flight_per_client"]
        return [asyncio.create_task(self.loop(c, ci, p))
                for ci, c in enumerate(self.com.clients) for p in range(per)]


async def _settle(com, deadline: float) -> None:
    """Until every replica has executed as far as any, and stays so."""
    last, since = None, time.monotonic()
    while time.monotonic() < deadline:
        seqs = [r.executed_seq for r in com.replicas]
        if seqs != last:
            last, since = seqs, time.monotonic()
        elif len(set(seqs)) == 1 and time.monotonic() - since > 1.0:
            return
        await asyncio.sleep(0.1)


def _counters(svc, gauge) -> dict:
    return dict(common.service_counters(svc), lag_sum=gauge.sum_ms, lag_n=gauge.samples)


def _check(com, load: _Load) -> dict:
    ref = KV()
    want_reply = 0
    for key, op, res, _, _ in sorted(load.acked, key=lambda a: a[3]):
        want_reply += ref.apply(op) != res
    either = {k: op.split(" ", 2)[2] for k, op in load.failed.items()}
    states = [json.loads(r.app.snapshot()) for r in com.replicas]
    return {
        "state_mismatches": {"value": sum(state_mismatches(ref.data, s, either) for s in states),
                             "limit": 0},
        "reply_mismatches": {"value": want_reply, "limit": 0},
        "unanswered_requests": {"value": len(load.failed), "limit": 0},
    }


async def _run(cfg, traffic, cell, seed, seconds, trace, control, t_start, torch, device):
    stamps = {"torch": time.monotonic()}
    com, verifier, svc = _build(cfg, traffic, seed, device, control)
    stamps["committee_bank_and_warm"] = time.monotonic()
    facts = common.device_facts(torch, device)
    # CUPTI's set-up takes seconds: the trace opens before the load
    hooks = common.TraceHooks(verifier) if trace else None
    com.start()
    gauge = com.lag_gauge = _lag_gauge()
    gauge.start()
    if control:
        controls.patch_committee(control, com)
    load = _Load(com, traffic, seed)
    tasks = load.start()
    stamps["trace_and_start"] = time.monotonic()
    await asyncio.sleep(cell["warm_s"])
    gc.freeze()  # what set-up made is never walked again
    w0 = stamps["load_before_window"] = time.monotonic()
    w1 = load.stop_at = w0 + seconds
    c0 = _counters(svc, gauge)
    await asyncio.sleep(seconds)
    c1 = _counters(svc, gauge)
    memory = common.card_memory_used(torch, device)
    done, late = await asyncio.wait(tasks, timeout=LATE_S + traffic["request_timeout_s"])
    for t in late:
        t.cancel()
    await _settle(com, time.monotonic() + SETTLE_S)
    traced = hooks.stop(w0, w1, facts["sms"]) if hooks is not None else None
    checks = _check(com, load)
    await com.stop()
    svc.close()
    window = [(t1 - t0) * 1e3 for _, _, _, t0, t1 in load.acked if w0 <= t1 <= w1]
    rec = {
        "correct": judge(checks),
        "attempted": len(load.acked) + len(load.failed),
        "failed": len(load.failed) + checks["reply_mismatches"]["value"],
        "checks": checks,
        "device": {"platform": facts["platform"], "kind": facts["kind"], "count": 1,
                   "memory_peak_bytes": memory},
        "setup_s": w0 - t_start,
        "window_s": seconds,
        "processes": 1,
        "committed": len(window),
        "window_latencies_ms": window,
        "passes": c1["passes"] - c0["passes"],
        "pass_items": c1["pass_items"] - c0["pass_items"],
        "host_prep_ms": c1["prep_ms"] - c0["prep_ms"],
        "host_prep_items": c1["pass_items"] - c0["pass_items"],
        "loop_lag_sum_ms": c1["lag_sum"] - c0["lag_sum"],
        "loop_lag_samples": c1["lag_n"] - c0["lag_n"],
        "forged_sent": len(load.forged),
        "forbidden_modules": forbidden_modules(),
        "setup_steps_s": {k: t - t_start for k, t in stamps.items()},
    }
    if traced is not None:
        rec.update(common.join_traces([traced], seconds, "event_loop"))
        rec["device"]["busy_s"] = rec["device_busy_s"]
        rec["device"]["window_s"] = seconds
    return rec
