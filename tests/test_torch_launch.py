"""The port's process entry points on the CPU: the launcher (replica and
client processes over localhost TCP, and gRPC where grpcio is installed)
against the JAX package's, and the two bench entry points' JSON lines."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout):
    env = dict(os.environ, JAX_PLATFORMS="cpu")  # no child touches a device
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=ROOT)


def _base_port(offset):
    # 25000-28500 with the client's +500, and 28500-32011 for the grpc
    # run's +3500: apart from the other tests' ranges (7400-11000,
    # 21000-24490) and below the kernel's ephemeral ports (32768 up), which
    # any outgoing connection of a concurrent test may hold
    return 25000 + (os.getpid() % 250) * 12 + offset


EXPECTED = {f"'put k{i} v{i}'": "'ok'" for i in range(8)}


def _launch(package, tmp_path, base_port, *extra):
    """-> {request: reply} of the client's result lines. The client prints
    its results in the order they complete, which depends on when the
    nodes came up (the JAX launcher starts its client after a fixed
    second, so under load some requests are retried and finish late):
    each request's reply is what both launchers must agree on."""
    out = _run([f"{package}.launch", "-n", "4", "--load", "8", "--verifier", "cpu",
                "--base-port", str(base_port), "--deploy-dir", str(tmp_path),
                "--keep", *extra], timeout=120)
    assert out.returncode == 0, (package, out.stdout[-800:], out.stderr[-800:])
    assert '"ops": 8' in out.stdout, (package, out.stdout[-800:])
    lines = [ln.split(" -> ") for ln in out.stdout.splitlines() if " -> " in ln]
    replies = dict(lines)
    assert len(replies) == len(lines), (package, lines)  # each request once
    return replies


def test_port_launch_prints_the_jax_launchers_results(tmp_path):
    """4 replica processes + 1 client process, 8 requests: the same
    replies as the JAX package's launcher gives."""
    got = _launch("simple_pbft_tpu_torch", tmp_path / "port", _base_port(0))
    want = _launch("simple_pbft_tpu", tmp_path / "jax", _base_port(5))
    assert got == want
    assert got == EXPECTED
    for i in range(4):  # every node was ready before the client ran
        assert (tmp_path / "port" / "log" / f"r{i}.status.json").exists()


def test_port_launch_over_grpc(tmp_path):
    pytest.importorskip("grpc")
    got = _launch("simple_pbft_tpu_torch", tmp_path, _base_port(0) + 3500,
                  "--transport", "grpc")
    assert got == EXPECTED


def _json_lines(stdout):
    return [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]


def test_bench_smoke_prints_one_cpu_line():
    out = _run(["simple_pbft_tpu_torch.bench", "--smoke"], timeout=120)
    assert out.returncode == 0, out.stderr[-1500:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "ed25519_verifies_per_sec_per_gpu"
    assert rec["platform"] == "cpu" and "error" not in rec
    assert rec["value"] > 0 and rec["batch"] == 32
    assert rec["e2e_verifies_per_sec"] > 0 and rec["host_prep_ms"] > 0


def test_bench_consensus_prints_one_line_per_config():
    out = _run(["simple_pbft_tpu_torch.bench_consensus", "--configs", "1",
                "--seconds", "2", "--verifier", "cpu", "--device", "cpu"],
               timeout=120)
    assert out.returncode == 0, out.stderr[-1500:]
    recs = _json_lines(out.stdout)
    assert [r["config"] for r in recs] == ["pbft-n4"]
    assert recs[0]["committed_req_s"] > 0 and recs[0]["client_timeouts"] == 0


def test_storm_passes_the_smokes_config5_checks(tmp_path):
    """BASELINE config 5's entry point (--storm) at n = 4 on the CPU
    verifier, one primary crash: its record and flight frames pass
    chip_smoke.py's own storm checks, the card's checks left out."""
    import importlib.util

    out = _run(["simple_pbft_tpu_torch.bench_consensus", "--configs", "1", "--storm",
                "--verifier", "cpu", "--crashes", "1", "--seconds", "6",
                "--view-timeout", "1", "--flight-dir", str(tmp_path)], timeout=120)
    assert out.returncode == 0, out.stderr[-1500:]
    (rec,) = _json_lines(out.stdout)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    summary = smoke.storm_checks(rec, str(tmp_path), n=4, crashes=1, device=False)
    assert summary["final_view"] >= 1 and summary["survivors"] == 3


@pytest.mark.parametrize("entry", ["node", "launch", "bench", "bench_consensus"])
def test_gpu_entry_point_refuses_to_run_without_cuda(entry, tmp_path):
    """On a host without CUDA the entry points, run with their default
    verifier and device, exit non-zero and serve or measure nothing on
    the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    if entry == "node":
        from simple_pbft_tpu_torch import deploy

        deploy.generate(str(tmp_path), n=4, clients=1, base_port=_base_port(9))
        args = ["simple_pbft_tpu_torch.node", "--id", "r0", "--deploy-dir",
                str(tmp_path), "--log-dir", ""]
    elif entry == "launch":
        args = ["simple_pbft_tpu_torch.launch", "-n", "4", "--load", "8",
                "--base-port", str(_base_port(7)), "--deploy-dir", str(tmp_path)]
    elif entry == "bench":
        args = ["simple_pbft_tpu_torch.bench"]
    else:
        args = ["simple_pbft_tpu_torch.bench_consensus", "--configs", "1",
                "--seconds", "1"]
    out = _run(args, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stdout + out.stderr
    if entry == "bench":  # the one JSON line, with the error
        (rec,) = _json_lines(out.stdout)
        assert "error" in rec and rec["value"] == 0.0
    elif entry == "launch":  # it raised before it deployed or spawned
        assert not (tmp_path / "committee.json").exists()
        assert "nodes ready" not in out.stdout
    else:
        assert '"committed_req_s"' not in out.stdout
