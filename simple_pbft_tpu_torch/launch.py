"""Launcher: ``python -m simple_pbft_tpu_torch.launch`` — the run.bat analog.

The reference ships a Windows-only batch script that builds two binaries,
starts 4 node processes and fires one client (run.bat:19-26). This
launcher generates a fresh deployment, spawns N replica processes, runs a
client workload against them, prints the client's stats line, and tears
everything down — cross-platform, any committee size.

The port's edits to the JAX package's launcher:

- It spawns ``simple_pbft_tpu_torch.node`` and ``.client_cli`` and passes
  ``--device`` on to every node.
- ``--verifier`` defaults to ``gpu`` (``cpu`` in the JAX launcher), so a
  bare launch verifies on the card; without CUDA it raises before it
  spawns a node. ``--verifier cpu`` asks for the CPU.
- In place of a fixed one-second sleep it waits until every node is
  ready: a node writes ``<deploy-dir>/log/<id>.status.json`` once it
  serves, and a ``gpu`` node first creates its CUDA context, builds its
  key bank and runs one pass per bucket, which takes seconds. It fails if
  a node exits first or the deadline passes, and prints the boot time.
- With ``--verifier gpu`` on a CUDA device it builds the native host
  helpers and the two CUDA kernels once before it spawns, so N nodes do
  not start N builds of the same sources at once.
- After the client returns it waits (briefly) until every node has
  executed every proposed block, so the nodes stop on one committed
  frontier and their final dumps agree.
- ``--device-profile S`` arms node r0's device profile for S seconds.
- It waits up to 30 s (not 5) for each node to stop: a node writes its
  final dumps, and the trace of an open profile, on the way out.
- ``--concurrency`` is passed to the client (its requests in flight,
  default 64 as the client's own). A replica process verifies only its
  own piles, and the adaptive route sends piles under its cutoff (which
  each process learns for itself; 20-120 items on the H100's host) to
  the CPU: at 64 in flight about half the nodes' piles stay under it, so
  a run that must put every node on the card raises the concurrency.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

BOOT_DEADLINE_S = 600.0
SETTLE_DEADLINE_S = 10.0


def _prebuild() -> None:
    """Build (or find fresh) every native library a gpu node loads."""
    from . import native
    from .ops import comb

    for ok in (native.available(), native.ed25519_available(),
               native.canonjson_available()):
        if not ok:
            print("warning: a native host helper did not build; nodes "
                  "use its Python fallback", file=sys.stderr)
    comb.accumulate_kernel.library()
    comb.encode_kernel.library()


def _status_path(deploy_dir: str, node_id: str) -> str:
    return os.path.join(deploy_dir, "log", f"{node_id}.status.json")


def _wait_ready(deploy_dir: str, procs: dict, deadline_s: float) -> float:
    """Seconds until every node wrote its status file; raises if a node
    exits or the deadline passes first."""
    t0 = time.perf_counter()
    waiting = dict(procs)
    while waiting:
        for node_id, p in list(waiting.items()):
            if os.path.exists(_status_path(deploy_dir, node_id)):
                del waiting[node_id]
            elif p.poll() is not None:
                raise SystemExit(f"node {node_id} exited with {p.returncode} "
                                 "before it was ready")
        if time.perf_counter() - t0 > deadline_s:
            raise SystemExit(f"nodes not ready after {deadline_s:.0f} s: "
                             f"{sorted(waiting)}")
        time.sleep(0.1)
    return time.perf_counter() - t0


def _frontier(deploy_dir: str, node_id: str):
    """A node's (executed sequence, next sequence it would propose) from
    its /metrics.json, None if it does not answer."""
    try:
        with open(_status_path(deploy_dir, node_id)) as fh:
            port = json.load(fh)["port"]
        url = f"http://127.0.0.1:{port}/metrics.json"
        with urllib.request.urlopen(url, timeout=2.0) as resp:
            rep = json.load(resp)["replica"]
        return rep["executed_seq"], rep["next_seq"]
    except (OSError, ValueError, KeyError):
        return None


def _settle(deploy_dir: str, node_ids, deadline_s: float) -> None:
    """Wait until every node has executed every proposed block. A client
    may return on speculative replies, before any node has committed the
    last block, so equal executed sequences alone are not enough."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < deadline_s:
        fronts = [_frontier(deploy_dir, i) for i in node_ids]
        if None not in fronts:
            proposed = max(nxt for _, nxt in fronts) - 1
            if all(done == proposed for done, _ in fronts):
                return
        time.sleep(0.1)


def main() -> None:
    ap = argparse.ArgumentParser(description="launch a local PBFT committee")
    ap.add_argument("-n", type=int, default=4, help="replica count")
    ap.add_argument("--load", type=int, default=16, help="client requests")
    ap.add_argument("--concurrency", type=int, default=64,
                    help="the client's requests in flight")
    ap.add_argument("--verifier", default="gpu")
    ap.add_argument("--device", default="cuda",
                    help="the gpu verifier's torch device, passed to every node")
    ap.add_argument("--transport", default="tcp", choices=["tcp", "grpc"])
    ap.add_argument("--base-port", type=int, default=7000)
    ap.add_argument("--deploy-dir", default=None, help="reuse/keep a deployment dir")
    ap.add_argument("--keep", action="store_true", help="don't delete the deploy dir")
    ap.add_argument("--trace", action="store_true",
                    help="enable the cross-replica trace plane on every "
                    "node (<deploy>/log/r*.spans.jsonl; join with "
                    "tools/slot_trace.py)")
    ap.add_argument("--device-profile", type=float, default=0.0,
                    help="arm node r0's torch.profiler capture for this many "
                    "seconds (<deploy>/log/device_profile); 0 = off")
    args = ap.parse_args()

    from . import deploy

    if args.verifier == "gpu":
        from . import resolve_device

        # raises without CUDA, before any node is spawned
        if resolve_device(args.device).type == "cuda":
            _prebuild()

    deploy_dir = args.deploy_dir or tempfile.mkdtemp(prefix="pbft_deploy_")
    deploy.generate(deploy_dir, n=args.n, clients=1, base_port=args.base_port)
    print(f"deployment: {deploy_dir} (n={args.n}, f={(args.n - 1) // 3})")
    node_ids = [f"r{i}" for i in range(args.n)]
    for node_id in node_ids:
        # a reused deploy dir must not look ready before its node is
        try:
            os.unlink(_status_path(deploy_dir, node_id))
        except FileNotFoundError:
            pass
    env = dict(os.environ)
    procs = {}
    rc = 1
    try:
        for node_id in node_ids:
            procs[node_id] = subprocess.Popen(
                [
                    sys.executable, "-m", "simple_pbft_tpu_torch.node",
                    "--id", node_id,
                    "--deploy-dir", deploy_dir,
                    "--verifier", args.verifier,
                    "--device", args.device,
                    "--transport", args.transport,
                ] + (["--trace", "1"] if args.trace else [])
                + (["--device-profile", str(args.device_profile)]
                   if args.device_profile > 0 and node_id == "r0" else []),
                env=env,
            )
        boot_s = _wait_ready(deploy_dir, procs, BOOT_DEADLINE_S)
        print(f"nodes ready: {args.n} in {boot_s:.3f} s", flush=True)
        rc = subprocess.call(
            [
                sys.executable, "-m", "simple_pbft_tpu_torch.client_cli",
                "--id", "c0",
                "--deploy-dir", deploy_dir,
                "--load", str(args.load),
                "--concurrency", str(args.concurrency),
                "--transport", args.transport,
            ],
            env=env,
        )
        _settle(deploy_dir, node_ids, SETTLE_DEADLINE_S)
    finally:
        for p in procs.values():
            p.send_signal(signal.SIGTERM)
        for p in procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if not args.keep and args.deploy_dir is None:
            import shutil

            shutil.rmtree(deploy_dir, ignore_errors=True)
    sys.exit(rc)


if __name__ == "__main__":
    main()
