"""Client binary: ``python -m simple_pbft_tpu_torch.client_cli``.

Parity target: the reference's client.go — which fire-and-forgets ONE
hard-coded request at the primary and exits without reading any reply
(client.go:27-34; its author's top gap, 需要改进的地方.md:3-9). This
client submits operations, waits for f+1 matching replies via the client
library, retries/rebroadcasts on timeout, and reports latency stats.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import time

from . import deploy
from .client import Client
from .node import make_transport


async def run_client(args) -> None:
    dep = deploy.load(os.path.join(args.deploy_dir, "committee.json"))
    seed = deploy.read_seed(args.deploy_dir, args.id)
    transport = make_transport(args.transport, args.id, dep)
    await transport.start()
    client = Client(
        client_id=args.id,
        cfg=dep.cfg,
        seed=seed,
        transport=transport,
        request_timeout=args.timeout,
    )
    client.start()

    ops = args.op or []
    if args.load:
        ops = [f"put k{i} v{i}" for i in range(args.load)]
    latencies = []
    results = []
    t_start = time.perf_counter()
    inflight = args.concurrency

    async def submit_one(op):
        t0 = time.perf_counter()
        res = await client.submit(op, retries=args.retries)
        latencies.append(time.perf_counter() - t0)
        results.append((op, res))

    for start in range(0, len(ops), inflight):
        await asyncio.gather(*(submit_one(op) for op in ops[start : start + inflight]))
    elapsed = time.perf_counter() - t_start

    for op, res in results[: args.print_results]:
        print(f"{op!r} -> {res!r}")
    if latencies:
        lat_sorted = sorted(latencies)
        print(
            json.dumps(
                {
                    "ops": len(latencies),
                    "elapsed_s": round(elapsed, 4),
                    "throughput_ops_per_s": round(len(latencies) / elapsed, 2),
                    "latency_p50_ms": round(lat_sorted[len(lat_sorted) // 2] * 1e3, 2),
                    "latency_p99_ms": round(
                        lat_sorted[int(len(lat_sorted) * 0.99)] * 1e3, 2
                    ),
                }
            )
        )
    await client.stop()
    await transport.stop()


def main() -> None:
    ap = argparse.ArgumentParser(description="simple_pbft_tpu_torch client")
    ap.add_argument("--id", default="c0", help="client id (must be in the deployment)")
    ap.add_argument("--deploy-dir", required=True)
    ap.add_argument(
        "--op", action="append", help="operation to submit (repeatable)"
    )
    ap.add_argument("--load", type=int, default=0, help="submit N generated puts")
    ap.add_argument("--concurrency", type=int, default=64)
    ap.add_argument("--timeout", type=float, default=1.0)
    ap.add_argument("--retries", type=int, default=5)
    ap.add_argument("--print-results", type=int, default=10)
    ap.add_argument("--transport", default="tcp", choices=["tcp", "grpc"])
    ap.add_argument("--log-level", default="WARNING")
    args = ap.parse_args()
    logging.basicConfig(level=args.log_level)
    if not args.op and not args.load:
        ap.error("need --op or --load")
    asyncio.run(run_client(args))


if __name__ == "__main__":
    main()
