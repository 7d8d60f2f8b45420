"""The port's telemetry, audit and knob planes against the JAX package's.

Before the port carried its own ``telemetry``, ``audit`` and ``controller``
modules, ``spans.configure`` and every ``LocalCommittee.attach_*`` hook of
the port raised ModuleNotFoundError. These tests pin the repair: each
works, and the same spans give the same JSONL records as the JAX
package's, timestamps aside.
"""

import asyncio
import json

import pytest

from simple_pbft_tpu import spans as jspans
from simple_pbft_tpu.committee import LocalCommittee as JaxCommittee
from simple_pbft_tpu_torch import spans as tspans
from simple_pbft_tpu_torch.committee import LocalCommittee

SPANS = [
    ("verify.host_prep", 0.0012, {"n": 32}),
    ("phase.prepare", 0.0041, {"view": 0, "seq": 7}),
    ("replica.verify_wait", 0.0007, {"node": "r2", "n": 5}),
    ("execute.final", 0.0003, {"view": 1, "seq": 9, "rid": "c0:12"}),
]


def _records(mod, path):
    mod.configure("r0", str(path))
    try:
        for stage, dur, kw in SPANS:
            mod.record(stage, dur, **kw)
        snap = mod.snapshot()
    finally:
        mod.recorder().close()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    for doc in lines:
        assert isinstance(doc.pop("t_mono"), float)
    return lines, snap


def test_spans_configure_writes_the_jax_packages_records(tmp_path):
    got, got_snap = _records(tspans, tmp_path / "port.spans.jsonl")
    want, want_snap = _records(jspans, tmp_path / "jax.spans.jsonl")
    assert got == want
    assert len(got) == len(SPANS) and {d["node"] for d in got} == {"r0", "r2"}
    assert got_snap["recorded"] == want_snap["recorded"] == len(SPANS)
    assert got_snap["persisted"] == want_snap["persisted"] == len(SPANS)
    assert got_snap["stages"].keys() == want_snap["stages"].keys()


def _hook_result(com, hook, tmp_path):
    """Call one attach_* hook; -> a comparable summary of what it built."""
    if hook == "attach_loop_lag":
        async def run():
            gauge = com.attach_loop_lag(interval=0.01)
            await asyncio.sleep(0.05)
            snap = gauge.snapshot()
            await gauge.stop()
            return sorted(snap)

        return asyncio.run(asyncio.wait_for(run(), 30))
    if hook == "attach_auditors":
        auditors = com.attach_auditors(log_dir=str(tmp_path))
        out = {rid: sorted(a.snapshot()) for rid, a in auditors.items()}
        for a in auditors.values():
            a.close()
        return out
    if hook == "attach_tracers":
        tracers = com.attach_tracers(sample_mod=4, trace_dir=str(tmp_path))
        out = sorted(tracers)
        for t in tracers.values():
            t.close()
        return out
    registry = com.attach_knobs()
    return sorted(registry.snapshot_block())


@pytest.mark.parametrize(
    "hook", ["attach_loop_lag", "attach_auditors", "attach_tracers", "attach_knobs"]
)
def test_committee_attach_hook_runs_like_the_jax_packages(hook, tmp_path):
    port = LocalCommittee.build(n=4, clients=1)
    ref = JaxCommittee.build(n=4, clients=1)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _hook_result(port, hook, tmp_path / "port")
    assert got == _hook_result(ref, hook, tmp_path / "jax")
    # the hook's plane now reaches every node's unified snapshot
    snap = port.node_telemetry("r0").snapshot()
    assert snap["replica"]["id"] == "r0"
    if hook == "attach_knobs":
        assert "knobs" in snap


@pytest.mark.parametrize("end", ["window", "stop_profile"])
def test_device_profile_records_work_on_the_loops_thread(end, tmp_path):
    """The port's --device-profile capture (devledger.arm_profile): started
    on the event loop's thread, it records that thread's torch work, and
    its trace is written when the window ends or at stop_profile."""
    import torch

    from simple_pbft_tpu_torch import devledger

    ledger = devledger.DeviceLedger()

    async def run():
        assert ledger.arm_profile(str(tmp_path), 0.2 if end == "window" else 60.0)
        assert not ledger.arm_profile(str(tmp_path), 1.0)  # one at a time
        x = torch.ones(64, 64)
        for _ in range(3):
            x = x @ x
        if end == "window":
            await asyncio.sleep(0.5)
        else:
            ledger.stop_profile()

    asyncio.run(asyncio.wait_for(run(), 60))
    assert ledger.profile_captures == 1
    (trace,) = tmp_path.glob("*.pt.trace.json")
    ops = {ev["name"] for ev in json.loads(trace.read_text())["traceEvents"]
           if ev.get("cat") == "cpu_op"}
    assert "aten::mm" in ops
