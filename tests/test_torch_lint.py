"""pbftlint over the port: no finding, and every suppression justified.

Without the baseline (`--no-baseline`, every finding counts) the run exits
0. With it, the port still has no finding, none baselined: the exit 1 of
that run comes only from the baseline's entries for the JAX package's
files, which a run over the port alone reports as stale."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lint(*args):
    return subprocess.run([sys.executable, "-m", "tools.pbftlint", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("baseline", [False, True], ids=["no-baseline", "baseline"])
def test_pbftlint_finds_nothing_in_the_port(baseline):
    if not baseline:
        proc = _lint("--no-baseline", "simple_pbft_tpu_torch")
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-1500:]
        assert "pbftlint: 0 finding(s)" in proc.stdout
        return
    proc = _lint("--json", "simple_pbft_tpu_torch")
    res = json.loads(proc.stdout)
    assert res["findings"] == [] and res["errors"] == [] and res["baselined"] == 0
    assert res["suppressed"] > 0
    assert all(key.split(":")[1].startswith("simple_pbft_tpu/")
               for key in res["stale_baseline"]), res["stale_baseline"]
