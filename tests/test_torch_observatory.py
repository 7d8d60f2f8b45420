"""The port's verify observatory (simple_pbft_tpu_torch/tools/) against the
repo's JAX-side tool (tools/verify_observatory.py), on the CPU.

- The same per-process device blocks and stage tables go through both
  tools' merge_device_blocks, analyze, dominant_limiter and render: the
  documents are equal, but for the roofline's peak and utilization when
  each tool is given its own platform's peak (the port's utilization
  keeps six places). The cases reach every
  limiter, an empty stage table and a reconciliation outside 15%.
- A port committee at n = 4 whose every pile goes through
  GpuVerifier(device="cpu"), run by bench_consensus --flight-dir, leaves
  flight and span files that the port's tool reads as a user would
  (python -m, exit 0, reconciled, shares summing to 1), and from which
  the JAX-side tool and critical_path give the port's documents.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from simple_pbft_tpu.crypto import costmodel as jax_costmodel
from simple_pbft_tpu_torch.crypto import costmodel
from simple_pbft_tpu_torch.tools import critical_path, verify_observatory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_observatory = _load_tool("verify_observatory")
jax_critical_path = _load_tool("critical_path")


def _block(node, busy, prep, queue, disp=10, shape="ed25519:fused/w4/b32", window=2.0):
    """One process's device block as a flight frame carries it."""
    lane = {"dispatches": disp, "items": 25 * disp, "pad_items": 7 * disp,
            "submissions": 3 * disp, "busy_s": busy, "host_prep_s": prep,
            "queue_wait_s": queue, "bytes_up": 101 * 32 * disp, "bytes_down": 32 * disp,
            "compiles": 0, "devices": 1}
    return {"node": node, "window_s": window, "lanes": {"ed25519": lane},
            "shapes": {shape: {"dispatches": disp, "items": 25 * disp, "pad_items": 7 * disp}}}


def _spans(device_ms, queue_ms=5.0, cpu_ms=0.0):
    """A critical_path stage table of the verify stages."""
    table = {"verify.device": {"count": 10, "total_ms": device_ms},
             "verify.queue": {"count": 10, "total_ms": queue_ms}}
    if cpu_ms:
        table["verify.cpu"] = {"count": 4, "total_ms": cpu_ms}
    return table


# name -> (device blocks, stage table, the limiter both tools must name)
CASES = {
    "bandwidth": ([_block("r0", 1.8, 0.01, 0.005)], _spans(1830.0), "bandwidth"),
    # two processes, one of them seen through two flight files
    "bandwidth_two_processes": ([_block("r0", 1.6, 0.02, 0.01), _block("r1", 1.7, 0.02, 0.01),
                                 _block("r1", 1.7, 0.02, 0.01)], _spans(3400.0), "bandwidth"),
    "backpressure": ([_block("r0", 1.4, 0.05, 1.9)], _spans(1500.0), "bandwidth"),
    "queue_starvation": ([_block("r0", 0.4, 0.01, 0.005)], _spans(420.0), "queue_starvation"),
    "device_compute": ([_block("r0", 1.8, 0.01, 0.005, shape="ed25519:ladder/w0/b32")],
                       _spans(1810.0), "device_compute"),
    "dispatch_gap": ([_block("r0", 0.2, 0.01, 0.7)], _spans(215.0, 700.0), "dispatch_gap"),
    "host_prep": ([_block("r0", 0.2, 0.9, 0.1)], _spans(1100.0), "host_prep"),
    "host_cpu_path": ([_block("r0", 0.1, 0.01, 0.005)], _spans(112.0, cpu_ms=5000.0),
                      "host_cpu_path"),
    "no_device_dispatches": ([_block("r0", 0.0, 0.0, 0.0, disp=0)], {}, "no_device_dispatches"),
    # a bench record's histogram summaries instead of a stage table
    "histogram_stages": ([_block("r0", 1.8, 0.01, 0.005)],
                         {"verify.device": {"mean": 181.0, "count": 10}}, "bandwidth"),
    "empty_stage_table": ([_block("r0", 1.8, 0.01, 0.005)], {}, "bandwidth"),
    "reconciliation_outside_15pct": ([_block("r0", 1.0, 0.01, 0.005)], _spans(2000.0),
                                     "bandwidth"),
}


@pytest.mark.parametrize("peak", [None, "platform"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_analyze_gives_the_jax_tools_document(case, peak):
    blocks, stages, limiter = CASES[case]
    merged = verify_observatory.merge_device_blocks(json.loads(json.dumps(blocks)))
    assert merged == jax_observatory.merge_device_blocks(json.loads(json.dumps(blocks)))
    port_peak = costmodel.PEAK_GATHER_GBPS["h100"] if peak else None
    jax_peak = jax_costmodel.PEAK_GATHER_GBPS["v5lite"] if peak else None
    got = verify_observatory.analyze(merged, stages, peak_gather_gbps=port_peak)
    want = jax_observatory.analyze(merged, stages, peak_gather_gbps=jax_peak)
    assert got["limiter"] == want["limiter"] == limiter
    gather = got["roofline"]["gather_bytes"]
    shares = got["decomposition"]["shares"]
    assert (verify_observatory.dominant_limiter(shares, merged, gather)
            == jax_observatory.dominant_limiter(shares, merged, gather) == limiter)
    rec = got["reconciliation"]
    assert rec["ok"] == (case != "reconciliation_outside_15pct")
    if merged["dispatches"]:
        assert abs(sum(shares.values()) - 1) <= 1e-4
    if peak:
        roof, jroof = got["roofline"], want["roofline"]
        assert roof.pop("peak_gather_gbps") == port_peak
        achieved = gather / merged["busy_s"] / 1e9 if merged["busy_s"] else 0.0
        assert roof.pop("utilization") == round(achieved / port_peak, 6)
        jroof.pop("peak_gather_gbps"), jroof.pop("utilization")
    else:
        assert verify_observatory.render(got) == jax_observatory.render(want)
    assert got == want


def _run(args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)


# bench_consensus at n = 4 on GpuVerifier(device="cpu"), every pile on the
# device path: the verifier's buckets cut to (8, 32), so that its warm and
# passes on the plain versions take seconds
BENCH = (
    "import asyncio, sys\n"
    "from simple_pbft_tpu_torch import bench_consensus\n"
    "from simple_pbft_tpu_torch.crypto import gpu_verifier\n"
    "gpu_verifier.BUCKETS = (8, 32)\n"
    "sys.argv = ['bench_consensus', *sys.argv[1:]]\n"
    "asyncio.run(bench_consensus.main())\n"
)


@pytest.fixture(scope="module")
def committee_run(tmp_path_factory):
    flight = str(tmp_path_factory.mktemp("observatory_flight"))
    out = _run(["-c", BENCH, "--configs", "1", "--seconds", "3", "--clients", "2",
                "--outstanding", "8", "--batch", "16", "--verifier", "gpu", "--device", "cpu",
                "--verify-cpu-cutoff", "0", "--flight-dir", flight])
    assert out.returncode == 0, out.stderr[-2000:]
    (rec,) = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert rec["n"] == 4 and rec["svc_device_passes"] > 0 and rec["svc_cpu_passes"] == 0
    return flight, rec


def test_port_tool_reads_a_port_committees_flight_dir(committee_run):
    flight, rec = committee_run
    out = _run(["-m", "simple_pbft_tpu_torch.tools.verify_observatory", "--flight-dir", flight,
                "--json"])
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(out.stdout)
    assert doc["device"]["dispatches"] >= rec["svc_device_passes"] > 0
    assert doc["device"]["processes"] == 1  # 4 flight files, one process's ledger
    assert abs(sum(doc["decomposition"]["shares"].values()) - 1) <= 1e-4
    assert doc["reconciliation"]["ok"], doc["reconciliation"]
    assert doc["reconciliation"]["spans_device_ms"] > 0
    assert doc["limiter"] in verify_observatory.LIMITERS
    assert doc["roofline"]["utilization"] is None and doc["roofline"]["gather_bytes"] > 0


def test_both_tools_give_one_verdict_on_the_port_committees_files(committee_run):
    """The same flight and span files through each tool's loaders and
    analysis: the same device blocks, stage table and document."""
    flight, _ = committee_run
    docs = []
    for obs, cp in ((verify_observatory, critical_path), (jax_observatory, jax_critical_path)):
        blocks = obs.device_blocks_from_flights(flight)
        assert len(blocks) == 4
        stages = cp._stage_table(cp.load_spans(cp.discover(flight)))
        docs.append((blocks, stages, obs.analyze(obs.merge_device_blocks(blocks), stages)))
    assert docs[0] == docs[1]
    assert docs[0][1]["verify.device"]["count"] > 0


def test_critical_path_runs_as_a_module_on_the_port_committees_spans(committee_run):
    flight, rec = committee_run
    out = _run(["-m", "simple_pbft_tpu_torch.tools.critical_path", "--log-dir", flight, "--json"])
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(out.stdout)
    spans = jax_critical_path.load_spans(jax_critical_path.discover(flight))
    assert doc == jax_critical_path.analyze(spans)
    # the record is taken before the committee stops: a pass may follow it
    assert doc["stages"]["verify.device"]["count"] >= rec["svc_device_passes"]
    assert doc["slots_complete"] > 0


@pytest.mark.parametrize("case", ["chunked_pile", "device_lock_held"])
def test_the_ledger_counts_a_piles_time_as_its_span_does(monkeypatch, case):
    """The service's verify.device span times a pile from its dispatch to
    its verdicts, once; the device ledger's host prep and round trips must
    tile the same time, within the observatory's tolerance:

    - chunked_pile: 70 items at a top bucket of 32 go as chunks of 32, 32
      and 6, all staged and enqueued before the first verdict is read (on
      CPU tensors each chunk's plain pass runs at its enqueue). The first
      chunk's round trip must not count the later chunks' passes and prep
      again;
    - device_lock_held: another pass holds the device lock for 1 s while
      the pile waits, staged. The wait is part of the pile's round trip."""
    import threading
    import time

    from simple_pbft_tpu_torch import devledger, spans
    from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
    from simple_pbft_tpu_torch.crypto import gpu_verifier
    from simple_pbft_tpu_torch.crypto.coalesce import VerifyService
    from simple_pbft_tpu_torch.crypto.verifier import BatchItem

    monkeypatch.setattr(gpu_verifier, "BUCKETS", (8, 32))
    seeds = [bytes([i + 1]) * 32 for i in range(5)]
    n = 70 if case == "chunked_pile" else 20
    items = [BatchItem(ref.public_key(seeds[i % 5]), b"pile %d" % i,
                       ref.sign(seeds[i % 5], b"pile %d" % i)) for i in range(n)]
    gpu = gpu_verifier.GpuVerifier(device="cpu", initial_keys=8)
    gpu.warm_for_population([ref.public_key(s) for s in seeds], max_sweep=32)
    svc = VerifyService(gpu, cpu_cutoff=0, max_batch=32, dispatch_deadline=None)
    devledger.configure("pile")
    spans.configure("pile")
    lock = gpu_verifier._DEVICE_LOCK
    try:
        if case == "device_lock_held":
            lock.acquire()
            threading.Timer(1.0, lock.release).start()
        t0 = time.perf_counter()
        assert svc.submit(items).result(timeout=300) == [True] * n
        assert time.perf_counter() - t0 >= (1.0 if case == "device_lock_held" else 0.0)
        svc.close()
        device = verify_observatory.merge_device_blocks([devledger.snapshot()])
        stages = spans.snapshot()["stages"]
    finally:
        devledger.configure("")
        spans.configure("")
    assert device["dispatches"] == (3 if case == "chunked_pile" else 1)
    assert stages["verify.device"]["count"] == 1
    rec = verify_observatory.analyze(device, stages)["reconciliation"]
    assert rec["ok"], rec
    # the pile's prep and round trips lie inside its span
    assert rec["ledger_device_ms"] <= rec["spans_device_ms"] * 1.001, rec
