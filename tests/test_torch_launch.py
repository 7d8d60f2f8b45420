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
    # 30000-37500 with the grpc run's +4000 and the client's +500: apart
    # from the other tests' ranges (7400-11000, 21000-24490)
    return 30000 + (os.getpid() % 300) * 10 + offset


def _launch(package, tmp_path, base_port, *extra):
    out = _run([f"{package}.launch", "-n", "4", "--load", "8", "--verifier", "cpu",
                "--base-port", str(base_port), "--deploy-dir", str(tmp_path),
                "--keep", *extra], timeout=120)
    assert out.returncode == 0, (out.stdout[-800:], out.stderr[-800:])
    assert '"ops": 8' in out.stdout, out.stdout[-800:]
    return [ln for ln in out.stdout.splitlines() if " -> " in ln]


def test_port_launch_prints_the_jax_launchers_results(tmp_path):
    """4 replica processes + 1 client process, 8 requests: the same
    replies as the JAX package's launcher gives."""
    got = _launch("simple_pbft_tpu_torch", tmp_path / "port", _base_port(0))
    want = _launch("simple_pbft_tpu", tmp_path / "jax", _base_port(5))
    assert got == want
    assert got == [f"'put k{i} v{i}' -> 'ok'" for i in range(8)]
    for i in range(4):  # every node was ready before the client ran
        assert (tmp_path / "port" / "log" / f"r{i}.status.json").exists()


def test_port_launch_over_grpc(tmp_path):
    pytest.importorskip("grpc")
    got = _launch("simple_pbft_tpu_torch", tmp_path, _base_port(0) + 4000,
                  "--transport", "grpc")
    assert got == [f"'put k{i} v{i}' -> 'ok'" for i in range(8)]


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
