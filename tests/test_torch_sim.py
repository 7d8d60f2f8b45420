"""The port's deterministic simulator (simple_pbft_tpu_torch/sim.py)
against the JAX package's, scenario by scenario.

Both packages run the same seeded scenario in this process; every field
of the result that does not read the wall clock must be equal: the
verdict, the failure, the trace fingerprint, the coverage counters, the
commits, the virtual time, the resolved fault schedule, the byzantine
set and each replica's application digest. The JAX run is the reference:
the repro artifacts' recorded fingerprints are not what either package
gives on this tree, so they are not compared.
"""

import json
import os
from dataclasses import replace

import pytest

from simple_pbft_tpu import sim as jax_sim
from simple_pbft_tpu_torch import sim as port_sim

REPROS = os.path.join(os.path.dirname(__file__), "sim_repros")
STORM = dict(
    n=4, requests=8, horizon=10.0, probes=2,
    gen=dict(crashes=1, partition_windows=1, drop_windows=1),
)
FIELDS = ("ok", "failure", "fingerprint", "coverage", "committed", "vtime_s",
          "schedule", "byzantine", "app_digests")
# the patience each artifact is judged at, as tests/test_sim.py judges it
PATIENCE = {"slow_failover_tail.json": 600.0}


def _fields(result):
    return {k: getattr(result, k) for k in FIELDS}


def _both(make):
    """make(sim module) -> Scenario; -> (JAX result, port result)."""
    return (jax_sim.run_scenario(make(jax_sim)),
            port_sim.run_scenario(make(port_sim)))


@pytest.mark.parametrize("seed", [11, 12])
def test_storm_scenario_equals_the_jax_sim(seed):
    want, got = _both(lambda m: m.Scenario(seed=seed, **STORM))
    assert _fields(got) == _fields(want)
    assert got.ok


def _artifact_scenario(module, name, keep_defects):
    with open(os.path.join(REPROS, name)) as fh:
        sc = module.scenario_from_artifact(json.load(fh))
    if name in PATIENCE:
        sc = replace(sc, probe_patience=PATIENCE[name])
    return sc if keep_defects else replace(sc, defects=())


@pytest.mark.parametrize("keep_defects", [True, False], ids=["defects", "fixed"])
@pytest.mark.parametrize("name", sorted(os.listdir(REPROS)))
def test_repro_artifact_equals_the_jax_sim(name, keep_defects):
    want, got = _both(lambda m: _artifact_scenario(m, name, keep_defects))
    assert _fields(got) == _fields(want)


def test_traced_scenario_writes_the_jax_sims_span_ledger(tmp_path):
    """The joined span ledger of a traced run is byte for byte the JAX
    sim's (virtual-clock timestamps, per-run span counters)."""
    dirs = {}
    results = {}
    for tag, module in (("jax", jax_sim), ("port", port_sim)):
        dirs[tag] = tmp_path / tag
        dirs[tag].mkdir()
        sc = module.Scenario(seed=5, n=4, clients=2, requests=10,
                             spec="shape=wan3dc", verify_signatures=False,
                             trace_dir=str(dirs[tag]))
        results[tag] = module.run_scenario(sc)
    assert _fields(results["port"]) == _fields(results["jax"])
    assert results["port"].ok, results["port"].failure
    ledgers = {tag: (d / "sim.spans.jsonl").read_bytes() for tag, d in dirs.items()}
    assert ledgers["port"] and ledgers["port"] == ledgers["jax"]
