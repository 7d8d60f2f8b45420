"""The port's replica-unit bench (simple_pbft_tpu_torch/bench_replica_unit.py)
against the JAX package's root script, at n = 4, 4 blocks of 8.

With the CPU verifier in both, every field that does not read the clock
is equal. Those are all but `req_s`, `ms_per_req`, `elapsed_s`,
`presign_s`, `verify_s` and `verify_share`: the traffic is queued whole
before the replica starts, so its sweeps, verified items and cache hits
are the same in every run.
"""

import asyncio
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_replica_unit as jax_ru  # noqa: E402  (the JAX package's root script)

from simple_pbft_tpu_torch import bench_replica_unit as port_ru  # noqa: E402

TIMED = {"req_s", "ms_per_req", "elapsed_s", "presign_s", "verify_s", "verify_share"}
GPU_FIELDS = {"platform", "svc_device_passes", "svc_cpu_passes", "svc_rtt_ms_ema",
              "kernel_launches", "bank_keys"}
SIZE = dict(n=4, blocks=4, batch=8)


def _run(module, mode, **kw):
    return asyncio.run(module.run_mode(mode, SIZE["n"], SIZE["blocks"], SIZE["batch"], **kw))


@pytest.mark.parametrize("mode", ["plain", "qc"])
def test_cpu_records_equal_the_jax_scripts(mode):
    want = _run(jax_ru, mode, verifier="cpu")
    got = _run(port_ru, mode, verifier="cpu")
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in TIMED} == \
        {k: v for k, v in want.items() if k not in TIMED}
    assert got["ok"] and got["completed_blocks"] == SIZE["blocks"]
    assert got["wire_messages"] == (SIZE["blocks"] * (1 + 2 * got["quorum"])
                                    if mode == "plain" else SIZE["blocks"] * 3)


@pytest.mark.parametrize("mode", ["plain", "qc"])
def test_gpu_verifier_on_cpu_tensors_commits_every_block(mode, monkeypatch):
    """--verifier gpu --device cpu: the GpuVerifier behind the verify
    service, on the kernels' plain versions, warmed to bucket 8."""
    monkeypatch.setenv("RU_MAX_SWEEP", "8")
    want = _run(jax_ru, mode, verifier="cpu")
    got = _run(port_ru, mode, verifier="gpu", device="cpu")
    assert set(got) == set(want) | GPU_FIELDS
    assert got["ok"] and got["completed_blocks"] == want["completed_blocks"] == SIZE["blocks"]
    assert got["platform"] == "cpu"
    assert got["bank_keys"] == SIZE["n"] + port_ru.N_CLIENTS
    assert set(got["kernel_launches"]) == {"fused_accumulate", "encode_verdict"}
    assert got["verify_items"] == want["verify_items"]


def _cli(*args, timeout=120):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", "simple_pbft_tpu_torch.bench_replica_unit",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)


def _bench_results():
    folder = os.path.join(ROOT, "bench_results")
    return {f: os.path.getmtime(os.path.join(folder, f)) for f in os.listdir(folder)}


def test_cli_without_cuda_raises_and_writes_nothing(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    before = _bench_results()
    out_file = tmp_path / "ru.jsonl"
    proc = _cli("--n", "4", "--blocks", "1", "--batch", "2", "--out", str(out_file))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "{" not in proc.stdout
    assert not out_file.exists()
    assert _bench_results() == before


def test_cli_prints_one_line_a_mode_and_writes_only_where_asked(tmp_path):
    before = _bench_results()
    proc = _cli("--verifier", "cpu", "--n", "4", "--blocks", "2", "--batch", "4")
    assert proc.returncode == 0, proc.stderr[-1500:]
    recs = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["mode"] for r in recs] == ["plain", "qc"]
    assert all(r["ok"] and r["completed_blocks"] == 2 for r in recs)
    assert _bench_results() == before
    out_file = tmp_path / "ru.jsonl"
    proc = _cli("--verifier", "cpu", "--n", "4", "--blocks", "2", "--batch", "4",
                "--modes", "plain", "--out", str(out_file))
    assert proc.returncode == 0, proc.stderr[-1500:]
    assert [json.loads(line)["mode"] for line in out_file.read_text().splitlines()] == ["plain"]
