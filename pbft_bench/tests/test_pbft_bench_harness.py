"""The harness on the CPU: a rehearsal at a tiny size (the program's
plain versions, the verifier's buckets cut) drives the timed path as a
run does, without the look for a card."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from pbft_bench import controls, harness

ROOT = harness.ROOT


def _run(args, cwd=ROOT, env=None, timeout=300):
    proc = subprocess.run([sys.executable, "-m", "pbft_bench.run", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


def _rehearse(workload, *extra, seconds="1.5", **kw):
    return _run(["--workload", workload, "--seed", str(2**31 + 11), "--seconds", seconds,
                 "--trace", "0", "--rehearse-cpu", *extra], **kw)


# The committee cell's entries, as the change that adds it to
# BENCHMARK.json would write them (its files are all in pbft_bench/).
COMMITTEE = {
    "workload": {"name": "n100-committee", "config": "pbft-n100", "traffic": "kv-closed-loop",
                 "chips": 1, "why": "the n=100 committee, 8 clients x 16 puts in flight"},
    "end_to_end": {"name": "committed_req_s", "unit": "req/s", "better": "higher",
                   "bound": 0.25, "source": "host_clock", "workloads": ["n100-committee"]},
    "per_layer": [
        {"name": f"{m}.committee", "unit": u, "better": b, "source": s, "layer": layer,
         "moves": "committed_req_s", "workloads": ["n100-committee"]}
        for m, u, b, s, layer in [
            ("commit_p95_ms", "ms", "lower", "host_clock", "consensus plane"),
            ("loop_lag_ms", "ms", "lower", "program_counter", "consensus plane"),
            ("items_per_pass", "items", "higher", "program_counter", "coalescing service"),
            ("host_prep_us_per_verify", "us", "lower", "program_span", "host staging"),
            ("device_idle_share", "%", "lower", "device_trace", "device")]],
}


# The shared flood's entries, as the change that brings it back to
# BENCHMARK.json would write them (its files are all in pbft_bench/).
SHARED_FLOOD = {
    "config": {"name": "pbft-n100", "source": "https://github.com/1556174776/simple_pbft",
               "file": "pbft_bench/configs/pbft-n100.json", "reduced": [],
               "why": "the n=100 committee's verify plane: one shared verify service"},
    "workload": {"name": "n100-shared-flood", "config": "pbft-n100", "traffic": "inbound-flood",
                 "chips": 1, "why": "the n=100 shared service fed 199-item inbound sweeps"},
}


def _pending_root(tmp_path):
    """A checkout whose BENCHMARK.json also holds the cells that wait: the
    committee and the shared flood."""
    for name in ("pbft_bench", "simple_pbft_tpu_torch"):
        os.symlink(os.path.join(ROOT, name), tmp_path / name)
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    if "n100-shared-flood" not in {w["name"] for w in bench["workloads"]}:
        if "pbft-n100" not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append(SHARED_FLOOD["config"])
        bench["workloads"].append(SHARED_FLOOD["workload"])
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"].endswith(".flood") or m["name"] == "verifies_per_s":
                m["workloads"].append("n100-shared-flood")
    bench["workloads"].append(COMMITTEE["workload"])
    bench["end_to_end"].insert(1, COMMITTEE["end_to_end"])
    bench["per_layer"] += COMMITTEE["per_layer"]
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    return tmp_path


@pytest.mark.parametrize("workload", ["n16-colocated-flood", "n100-shared-flood",
                                      "n100-committee"])
def test_rehearsal_is_correct_and_prints_its_checks_last(workload, tmp_path):
    root = _pending_root(tmp_path)
    line, err = _rehearse(workload, cwd=root)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0 for c in line["checks"].values())
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    spec = harness.Spec(workload, root=str(root))
    assert set(line["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert line["metrics"]["setup_s"]["value"] > 0
    for m in spec.per_layer:  # every per-layer metric has its reader
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("control", controls.FLOOD)
def test_flood_control_and_faults_turn_correct_false(control):
    line, _ = _rehearse("n16-colocated-flood", "--control", control)
    assert line["correct"] is False
    assert line["checks"]["wrong_verdicts"]["value"] > 0


@pytest.mark.parametrize("control", controls.COMMITTEE)
def test_committee_control_and_faults_turn_correct_false(control, tmp_path):
    line, _ = _rehearse("n100-committee", "--control", control, seconds="2",
                        cwd=_pending_root(tmp_path))
    assert line["correct"] is False


def test_no_card_exits_nonzero_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "pbft_bench.run", "--workload",
                           "n16-colocated-flood", "--seed", "1", "--seconds", "1"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "pbft_bench"), tmp_path / "pbft_bench")
    proc = subprocess.run([sys.executable, "-m", "pbft_bench.run", "--workload",
                           "n16-colocated-flood", "--seed", "1", "--seconds", "1",
                           "--rehearse-cpu"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


NEW_METRIC = '''"""Items a device pass, as a test adds it."""


def read(record):
    return record["pass_items"] / record["passes"] if record["passes"] else None
'''


def test_new_config_mix_cell_and_metric_are_found_as_files(tmp_path):
    """A later change adds a cell by adding files and entries, editing none."""
    shutil.copytree(os.path.join(ROOT, "pbft_bench"), tmp_path / "pbft_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "simple_pbft_tpu_torch"), tmp_path / "simple_pbft_tpu_torch")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b = tmp_path / "pbft_bench"
    cfg = json.load(open(b / "configs" / "pbft-n16.json"))
    json.dump(dict(cfg, name="pbft-n7", n=7, f=2, processes=2), open(b / "configs" / "pbft-n7.json", "w"))
    mix = json.load(open(b / "traffic" / "inbound-flood.json"))
    json.dump(dict(mix, corrupt_one_in=16), open(b / "traffic" / "sparse-flood.json", "w"))
    json.dump({"warm_s": 0.2, "reference_sample": 4}, open(b / "cells" / "n7-flood.json", "w"))
    (b / "metrics" / "pass_items_seen.flood.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "pbft-n7", "source": "test", "reduced": [],
                             "file": "pbft_bench/configs/pbft-n7.json", "why": "test"})
    bench["workloads"].append({"name": "n7-flood", "config": "pbft-n7",
                               "traffic": "sparse-flood", "chips": 1, "why": "test"})
    next(m for m in bench["end_to_end"] if m["name"] == "verifies_per_s")["workloads"].append(
        "n7-flood")
    bench["per_layer"].append({"name": "pass_items_seen.flood", "unit": "items",
                               "better": "higher", "source": "program_counter",
                               "layer": "coalescing service", "moves": "verifies_per_s",
                               "workloads": ["n7-flood"]})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    line, _ = _rehearse("n7-flood", cwd=tmp_path)
    assert line["correct"] is True and "verifies_per_s" in line["metrics"]
    spec = harness.Spec("n7-flood", root=str(tmp_path), bench_dir=str(b))
    assert spec.config["n"] == 7 and spec.traffic["corrupt_one_in"] == 16
    assert [m["name"] for m in spec.per_layer][-1] == "pass_items_seen.flood"
    assert harness.read_metrics(spec, spec.per_layer[-1:], {"pass_items": 10, "passes": 4}) == {
        "pass_items_seen.flood": {"value": 2.5, "unit": "items"}}


def test_a_rehearsal_loads_the_port_and_no_jax(tmp_path):
    """The committee runs in the process that prints; a flood's processes
    report their own modules in the record, which the harness checks."""
    code = ("import sys, time; from pbft_bench import harness; "
            "harness.main(['--workload', 'n100-committee', '--seed', '5', '--seconds', '1', "
            "'--rehearse-cpu'], time.monotonic()); "
            "names = {m.split('.')[0] for m in sys.modules}; "
            "print('PORT', 'simple_pbft_tpu_torch' in names, harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=_pending_root(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "PORT True []"


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["simple_pbft_tpu_torch.crypto", "numpy"]) == []
    assert harness.forbidden_modules(["simple_pbft_tpu.crypto", "jax.numpy", "jaxlib"]) == [
        "jax", "jaxlib", "simple_pbft_tpu"]


REFERENCE_FILES = ["reference/ed25519.py", "reference/kv.py", "signing.py", "pool.py",
                   "roofline.py"]


@pytest.mark.parametrize("path", REFERENCE_FILES)
def test_the_references_import_nothing_of_the_program(path):
    tree = ast.parse(open(os.path.join(ROOT, "pbft_bench", path)).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not {x.split(".")[0] for x in names} & {"simple_pbft_tpu_torch", *harness.FORBIDDEN}


def test_loading_the_references_loads_no_program_module():
    code = ("import sys; import pbft_bench.reference.ed25519, pbft_bench.reference.kv, "
            "pbft_bench.signing, pbft_bench.pool, pbft_bench.roofline; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'simple_pbft_tpu_torch', 'simple_pbft_tpu', 'jax', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(tmp_path):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line, _ = _run(["--workload", "n100-shared-flood", "--seed", "3000000019",
                    "--seconds", "2", "--trace", "0"], cwd=_pending_root(tmp_path), timeout=1200)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
