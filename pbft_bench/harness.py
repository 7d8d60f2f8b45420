"""The benchmark's driver, run by `python -m pbft_bench.run`.

Everything that belongs to one cell is found by name, so a cell, a
configuration, a traffic mix or a per-layer metric is added as files:

- `BENCHMARK.json` (the checkout's root): the cell's configuration and
  traffic mix, and the metrics it reports;
- `configs/<config>.json`: the deployment;
- `traffic/<mix>.json`: the mix's parameters, and `driver`, the module
  of `drivers/` that generates and drives it;
- `cells/<cell>.json`: the cell's own run parameters;
- `metrics/<metric>.py`: a reader, `read(record) -> number or None`,
  of the record a driver returns.

A driver's record holds `correct`, `attempted`, `failed`, `checks` (each
number compared, with its limit), `device` and what its metrics read.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# modules that must not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "simple_pbft_tpu")


class NoCard(RuntimeError):
    """No CUDA card, or fewer than the cell asks for."""


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (`simple_pbft_tpu_torch` is the port, not the JAX
    package)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Spec:
    """One cell, as the files name it."""

    def __init__(self, workload: str, root: str = ROOT, bench_dir: str = HERE):
        bench = _json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
        self.workload = workload
        self.entry = cells[workload]
        self.chips = self.entry["chips"]
        self.bench_dir = bench_dir
        self.config = _json(os.path.join(bench_dir, "configs", self.entry["config"] + ".json"))
        self.traffic = _json(os.path.join(bench_dir, "traffic", self.entry["traffic"] + ".json"))
        self.cell = _json(os.path.join(bench_dir, "cells", workload + ".json"))

        def mine(m: dict) -> bool:
            return "workloads" not in m or workload in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def driver(self):
        return importlib.import_module(f"pbft_bench.drivers.{self.traffic['driver']}")

    def reader(self, metric: str):
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(f"pbft_bench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def read_metrics(spec: Spec, metrics: List[dict], record: dict) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = spec.reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(spec: Spec, record: dict, trace: bool) -> dict:
    metrics = read_metrics(spec, spec.per_layer if trace else spec.end_to_end, record)
    line = {"correct": record["correct"], "attempted": record["attempted"],
            "failed": record["failed"], "metrics": metrics, "device": record["device"]}
    if trace and record.get("breakdown"):
        line["breakdown"] = record["breakdown"]
    line["checks"] = record["checks"]
    return line


def judge(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def main(argv: Optional[List[str]], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="python -m pbft_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a planted fault or the control (pbft_bench/controls.py), for the
    # benchmark's own tests and control runs; never set by a check
    ap.add_argument("--control", default=None, help=argparse.SUPPRESS)
    # the tests' rehearsal on the CPU at a tiny size
    ap.add_argument("--rehearse-cpu", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    spec = Spec(args.workload)
    try:
        record = spec.driver().run(spec, seed=args.seed, seconds=args.seconds,
                                   trace=bool(args.trace), control=args.control,
                                   t_start=t_start, rehearse=args.rehearse_cpu)
    except NoCard as e:
        print(f"pbft_bench: {e}", file=sys.stderr)
        return 2
    found = sorted(set(forbidden_modules()) | set(record.get("forbidden_modules", [])))
    if found:
        print(f"pbft_bench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    line = result_line(spec, record, bool(args.trace))
    print("setup steps, s from start: " + json.dumps(record.get("setup_steps_s")),
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
