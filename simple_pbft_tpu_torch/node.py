"""Replica node binary: ``python -m simple_pbft_tpu_torch.node``.

Parity target: the reference's pbftNode.go (flags -id/-log, one process
per replica, blocking serve). Here: deployment document instead of a
hard-coded table, pluggable verifier backend, structured logging, clean
shutdown.

The port's edits to the JAX package's node: ``--verifier gpu`` in place
of ``tpu`` (a ``VerifyService`` over a ``GpuVerifier``), and the default
(``cpu`` in the JAX node), so a bare node verifies on the card;
``--verifier cpu`` asks for the CPU. ``--device`` names the device the
``gpu`` verifier runs on (``cuda`` unless the caller asks for ``cpu``;
without CUDA a ``cuda`` node raises instead of serving).
torch is imported only inside the ``gpu`` branch, so a ``cpu`` node
never loads it. ``--device-profile`` captures with torch.profiler, whose
session starts and ends on the event loop's thread; shutdown ends a
window still open and writes its trace.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal

from . import deploy
from .consensus.replica import Replica
from .crypto.verifier import CpuVerifier, InsecureVerifier, best_cpu_verifier
from .transport.tcp import TcpTransport


def make_transport(name: str, node_id: str, dep: "deploy.Deployment"):
    """tcp (default, intra-host) or grpc (the DCN path, SURVEY.md §2.3)."""
    cls = TcpTransport
    if name == "grpc":
        from .transport.grpc import GrpcTransport

        cls = GrpcTransport
    elif name != "tcp":
        raise SystemExit(f"unknown transport: {name}")
    return cls(
        node_id=node_id,
        listen_addr=dep.addr(node_id),
        peers=dep.peers_for(node_id),
    )


def make_verifier(
    name: str,
    dep=None,
    verify_max_pending: int = 65536,
    verify_deadline: float = 60.0,
    device: str = "cuda",
):
    if name == "gpu":
        from .crypto.coalesce import VerifyService
        from .crypto.gpu_verifier import GpuVerifier

        # overload knobs (docs/RESILIENCE.md): bounded admission rejects
        # with Overloaded past max_pending; the dispatch-deadline
        # watchdog fails a stalled device sweep over to the CPU verifier
        # and quarantines the device path (deadline <= 0 disables it)
        svc_kw = dict(
            max_pending=verify_max_pending,
            dispatch_deadline=verify_deadline if verify_deadline > 0 else None,
        )
        if dep is None:
            return VerifyService(GpuVerifier(device=device), **svc_kw)
        # Size the key bank to the deployment's published key population
        # and run every batch bucket once before serving traffic: a bank
        # growing under live traffic re-uploads its tables mid-consensus,
        # and a first-time shape after warmup counts in
        # post_warm_compiles. The warm runs THROUGH the service
        # (shape-stable coalescing): a coalesced take can reach the
        # service's max_batch even when one replica's drain sweep is
        # smaller, so warming only the sweep bound would leave the top
        # buckets cold. The VerifyService wrapper gives the node
        # async non-blocking dispatch and a CPU path for tiny sweeps
        # (one process = one replica here, so coalescing is across
        # consecutive sweeps rather than replicas).
        pubkeys = list(dep.cfg.pubkeys.values())
        svc = VerifyService(
            GpuVerifier(device=device, initial_keys=len(pubkeys) + 32),
            **svc_kw,
        )
        svc.warm_for_population(pubkeys, max_sweep=4096)
        return svc
    if name == "cpu":
        return best_cpu_verifier()
    if name == "cpu-pure":
        return CpuVerifier()
    if name == "insecure":
        return InsecureVerifier()
    raise SystemExit(f"unknown verifier backend: {name}")


def _dump_final(node_id: str, replica, transport, watchdog=None) -> None:
    """Shutdown dump: counters + sweep/verify/commit histograms as one
    JSON line each — the observability the perf work steers by (VERDICT
    weak #8). Called from run_node's ``finally`` so a FATAL EXCEPTION
    leaves the same post-mortem a clean SIGTERM would have (once, a
    crash lost everything). With a progress watchdog attached, the
    same path writes a FULL forensic autopsy (task/thread stacks,
    in-flight instances, recent spans) — so SIGTERM/SIGINT leaves the
    deep dump too, not just flight-interval snapshots."""
    logging.info("%s: stats %s", node_id, replica.stats.dump(replica.metrics))
    logging.info(
        "%s: transport %s", node_id, dict(getattr(transport, "metrics", {}))
    )
    svc = replica.verifier
    if hasattr(svc, "snapshot"):
        # overload-resilience counters (crypto/coalesce.py): was this run
        # ever shedding, did the device watchdog fire, how deep did the
        # pending pile get — the post-mortem for any degraded window
        logging.info("%s: verify service %s", node_id, svc.snapshot())
    auditor = getattr(replica, "auditor", None)
    if auditor is not None:
        # the accountability summary: did this node witness any safety
        # violation, and where its evidence ledger lives (docs/AUDIT.md)
        logging.info("%s: audit %s", node_id, auditor.snapshot())
    from . import sanitize

    viols = sanitize.take_violations()
    if viols:
        # an armed sanitizer's findings must reach the operator, not
        # die with the process (violations never raise into consensus)
        logging.warning(
            "%s: %s", node_id, sanitize.format_violations(viols)
        )
    if watchdog is not None:
        try:
            # a DISTINCT file: the shutdown snapshot must never overwrite
            # a mid-run stall autopsy at the watchdog's own path — that
            # wedged-state forensic is the artifact this subsystem exists
            # to preserve
            final_path = (
                watchdog.path.replace(".autopsy.json", ".final.autopsy.json")
                if watchdog.path else None
            )
            path = watchdog.dump(
                "final dump (signal or fatal exit)", path=final_path
            )
            if path:
                logging.info("%s: final autopsy at %s", node_id, path)
        except Exception:
            logging.exception("%s: final autopsy failed", node_id)


async def run_node(args) -> None:
    from . import spans
    from .telemetry import (
        FlightRecorder,
        LoopLagGauge,
        NodeTelemetry,
        ProgressWatchdog,
        RequestTracer,
        StatusServer,
        resolve_sample_mod,
        write_status_file,
    )

    dep = deploy.load(os.path.join(args.deploy_dir, "committee.json"))
    seed = deploy.read_seed(args.deploy_dir, args.id)
    transport = make_transport(args.transport, args.id, dep)
    await transport.start()
    if getattr(args, "wan_profile", ""):
        # WAN rehearsal: impose the named profile's per-link
        # latency/jitter/loss on this node's OUTBOUND links. Every node
        # of the committee should run the same profile so both directions
        # of each pair are shaped (docs/SCENARIOS.md).
        from .faults import ShapedTransport

        transport = ShapedTransport.wrap_profile(
            transport, args.wan_profile, list(dep.cfg.replica_ids)
        )
    # verifier construction includes warm_for_population — the CUDA
    # context, the key bank and one pass per bucket. Run it off-loop:
    # the transport is already started, and blocking the loop here
    # stalls its accept / reconnect machinery (and every heartbeat) for
    # the whole warm. Found by the PBFT_SANITIZE=loop sanitizer: the
    # static checker cannot resolve the call (warm_for_population is not a
    # unique method name) — exactly the dynamic-backstop case.
    verifier = await asyncio.to_thread(
        make_verifier,
        args.verifier,
        dep,
        verify_max_pending=args.verify_max_pending,
        verify_deadline=args.verify_deadline,
        device=args.device,
    )
    replica = Replica(
        node_id=args.id,
        cfg=dep.cfg,
        seed=seed,
        transport=transport,
        verifier=verifier,
        max_drain=args.max_drain,
        shed_watermark=args.shed_watermark,
    )
    log_dir = getattr(args, "resolved_log_dir", None)
    # per-stage latency attribution: spans always accumulate
    # in-memory histograms; with a log_dir they also land as JSONL for
    # tools/critical_path.py's cross-node decomposition
    spans.configure(
        args.id,
        os.path.join(log_dir, f"{args.id}.spans.jsonl") if log_dir else None,
    )
    # cross-replica trace plane: wire-envelope stamping is
    # per-process global and off by default; edge/quorum docs share the
    # span ledger, so a sink (log_dir) is required for them to persist
    if getattr(args, "trace", 0) and log_dir:
        from . import trace as trace_plane

        trace_plane.configure(True)
    # device-plane observatory: reset the per-dispatch device
    # ledger HERE — after the verifier warm, so warmup passes never
    # pollute the serving window's occupancy/rate aggregates, and in
    # lockstep with spans so tools/verify_observatory.py can reconcile
    # the two surfaces over the same window
    from . import devledger

    devledger.configure(args.id)
    if getattr(args, "device_profile", 0) > 0 and log_dir:
        # optional deep capture: ONE bounded torch.profiler trace window,
        # started here on the loop's thread (a torch.profiler session
        # records only from the thread that starts it) and ended on it,
        # which blocks the loop while the trace is written; artifacts
        # land under <log-dir>/device_profile for offline analysis next
        # to the flight timeline
        devledger.arm_profile(
            os.path.join(log_dir, "device_profile"), args.device_profile
        )
    tracer = None
    sample_mod = resolve_sample_mod(args.trace_sample)
    if sample_mod > 0 and log_dir:
        tracer = RequestTracer(
            args.id,
            sample_mod=sample_mod,
            path=os.path.join(log_dir, f"{args.id}.trace.jsonl"),
        )
        replica.tracer = tracer
    auditor = None
    if args.audit and log_dir:
        # consensus audit plane: online safety-invariant
        # monitor over the verified message stream; violations become
        # tamper-evident records in <log-dir>/<id>.evidence.jsonl and
        # per-slot observations in <id>.audit.jsonl for the cross-node
        # divergence join (tools/ledger_audit.py, docs/AUDIT.md)
        from .audit import SafetyAuditor

        auditor = SafetyAuditor(args.id, dep.cfg, log_dir=log_dir)
        replica.auditor = auditor
    lag = LoopLagGauge()
    telemetry = NodeTelemetry(
        args.id, replica=replica, transport=transport, tracer=tracer,
        loop_lag=lag,
    )
    status = None
    recorder = None
    watchdog = None
    try:
        replica.start()
        lag.start()
        if args.status_port >= 0:
            # live telemetry plane: /metrics.json /healthz /trace.json
            status = StatusServer(telemetry, port=args.status_port)
            await status.start()
            if log_dir:
                write_status_file(log_dir, args.id, status.bound_port)
            logging.info(
                "%s status endpoint on http://127.0.0.1:%d/metrics.json",
                args.id, status.bound_port,
            )
        if log_dir and args.flight_interval > 0:
            # flight recorder: a wedged or SIGKILLed node still leaves a
            # snapshot timeline on disk
            recorder = FlightRecorder(
                telemetry,
                os.path.join(log_dir, f"{args.id}.flight.jsonl"),
                interval=args.flight_interval,
            )
            recorder.start()
        if args.stall_deadline > 0:
            # wedge autopsy: no commit for --stall-deadline
            # seconds while client work is outstanding dumps a forensic
            # snapshot — a silent wedge leaves a diagnosis file
            watchdog = ProgressWatchdog(
                telemetry,
                path=(
                    os.path.join(log_dir, f"{args.id}.autopsy.json")
                    if log_dir else None
                ),
                deadline=args.stall_deadline,
                flight=recorder,
            )
            watchdog.start()
            if auditor is not None:
                # a safety violation triggers the same forensic dump
                # path as a stall (docs/AUDIT.md)
                auditor.attach_watchdog(watchdog)
        logging.info(
            "%s listening on %s (verifier=%s, n=%d, f=%d)",
            args.id, dep.addr(args.id), args.verifier, dep.cfg.n, dep.cfg.f,
        )

        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await replica.stop()
        await transport.stop()
    finally:
        # fires on clean shutdown AND on a fatal exception out of the run
        # loop: the stats/transport/overload dumps (plus the recorder's
        # final frame) must not depend on an orderly exit — and no
        # telemetry teardown failure may swallow them either
        try:
            if watchdog is not None:
                await watchdog.stop()
            await lag.stop()
            if recorder is not None:
                await recorder.stop()
            if status is not None:
                await status.stop()
            if tracer is not None:
                tracer.close()
            if auditor is not None:
                auditor.close()
            # a capture window still open at shutdown is closed and its
            # trace written now, on the thread that started it: the
            # process would otherwise exit inside the window and lose it
            devledger.stop_profile()
        except Exception:
            logging.exception("%s: telemetry teardown failed", args.id)
        _dump_final(args.id, replica, transport, watchdog=watchdog)
        spans.recorder().close()


def main() -> None:
    ap = argparse.ArgumentParser(description="simple_pbft_tpu_torch replica node")
    ap.add_argument("--id", required=True, help="replica id (e.g. r0)")
    ap.add_argument(
        "--deploy-dir",
        required=True,
        help="directory holding committee.json and <id>.seed",
    )
    ap.add_argument(
        "--verifier",
        default="gpu",
        choices=["cpu", "cpu-pure", "gpu", "insecure"],
        help="signature verification backend",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="gpu verifier: the torch device it runs on; cpu runs the "
        "kernels' plain versions (tests, CPU-only hosts). Without CUDA a "
        "cuda node exits instead of serving",
    )
    ap.add_argument(
        "--transport",
        default="tcp",
        choices=["tcp", "grpc"],
        help="wire transport (grpc = HTTP/2 streams, the DCN path)",
    )
    ap.add_argument(
        "--wan-profile", default="",
        help="wrap the wire transport in a deterministic link shaper "
        "(faults.ShapedTransport) with the named WAN profile — wan3dc "
        "(three datacenters, ~12 ms inter-DC), lossy (5%% iid loss) — "
        "for degraded-network rehearsals (docs/SCENARIOS.md)",
    )
    ap.add_argument(
        "--max-drain", type=int, default=4096,
        help="max messages drained per sweep (inbound batch bound)",
    )
    ap.add_argument(
        "--shed-watermark", type=int, default=0,
        help="decoded-sweep size beyond which deferrable message classes "
        "(client requests, fetch/probe asks) are shed in favor of "
        "quorum-critical traffic; 0 = 3/4 of --max-drain "
        "(docs/RESILIENCE.md)",
    )
    ap.add_argument(
        "--verify-max-pending", type=int, default=65536,
        help="gpu verifier: pending-item cap before submits are "
        "admission-rejected with Overloaded (bounded queue depth)",
    )
    ap.add_argument(
        "--verify-deadline", type=float, default=60.0,
        help="gpu verifier: seconds a device dispatch may run before the "
        "watchdog fails the sweep over to the CPU verifier and "
        "quarantines the device path (0 disables)",
    )
    ap.add_argument(
        "--status-port", type=int, default=0,
        help="live telemetry endpoint (/metrics.json, /healthz, "
        "/trace.json) on 127.0.0.1; 0 = ephemeral port (written to "
        "<log-dir>/<id>.status.json for pbft_top discovery), "
        "negative = disabled (docs/OBSERVABILITY.md)",
    )
    ap.add_argument(
        "--flight-interval", type=float, default=1.0,
        help="flight recorder: seconds between telemetry snapshots "
        "appended to <log-dir>/<id>.flight.jsonl (crash-surviving "
        "timeline); 0 disables",
    )
    ap.add_argument(
        "--trace-sample", type=float, default=128,
        help="phase-level request tracing: N > 1 keeps ~1/N of requests "
        "(deterministic by hash of (client, timestamp), so every node "
        "samples the SAME requests); a fraction in (0, 1] keeps that "
        "share — '--trace-sample 1.0' is the explicit full-fidelity "
        "debug mode; 0 = off. Sampling loss is counted in the "
        "snapshot's tracer.trace_dropped. Events go to "
        "<log-dir>/<id>.trace.jsonl",
    )
    ap.add_argument(
        "--trace", type=int, default=0,
        help="cross-replica trace plane (needs a log dir): stamp "
        "unsigned trace envelopes on outbound consensus wires and "
        "recv-stamp inbound ones into <log-dir>/<id>.spans.jsonl edge "
        "docs, plus per-certificate quorum arrival-order records; join "
        "all nodes' ledgers with tools/slot_trace.py (clock skew is "
        "solved offline from the edges themselves); 0 disables "
        "(docs/OBSERVABILITY.md)",
    )
    ap.add_argument(
        "--audit", type=int, default=1,
        help="online safety auditor (needs a log dir): checks "
        "equivocation / checkpoint-consistency / commit-uniqueness / "
        "certificate-honesty invariants over the verified message "
        "stream, appends tamper-evident evidence to "
        "<log-dir>/<id>.evidence.jsonl and per-slot observations to "
        "<id>.audit.jsonl (joined across nodes by "
        "tools/ledger_audit.py); 0 disables (docs/AUDIT.md)",
    )
    ap.add_argument(
        "--device-profile", type=float, default=0,
        help="device-plane deep capture: arm ONE bounded torch.profiler "
        "trace of this many seconds right after boot (it starts and ends "
        "on the event loop's thread, which its end blocks while the trace "
        "is written; shutdown ends an open window); artifacts land under "
        "<log-dir>/device_profile. 0 = off. The always-on per-dispatch "
        "device ledger (docs/OBSERVABILITY.md §device observatory) "
        "does not need this — the flag is for kernel-level forensics",
    )
    ap.add_argument(
        "--stall-deadline", type=float, default=30.0,
        help="wedge autopsy: seconds without a committed block (while "
        "client work is outstanding) before a forensic dump — task/"
        "thread stacks, verify/QC lane depths, in-flight instances, "
        "recent spans — is written to <log-dir>/<id>.autopsy.json "
        "(0 disables; docs/OBSERVABILITY.md)",
    )
    ap.add_argument("--log-level", default="INFO")
    ap.add_argument(
        "--log-dir",
        default=None,
        help="per-node rotating log file directory (default: "
        "<deploy-dir>/log, matching the reference's zap/lumberjack "
        "layout; empty string disables the file sink)",
    )
    args = ap.parse_args()
    from .logutil import setup_node_logging

    log_dir = args.log_dir
    if log_dir is None:
        log_dir = os.path.join(args.deploy_dir, "log")
    setup_node_logging(args.id, log_dir or None, level=args.log_level)
    # the telemetry plane (flight recorder, trace sink, status-file
    # discovery) writes next to the rotating log
    args.resolved_log_dir = log_dir or None
    # arm the opt-in loop sanitizer BEFORE the loop exists: install()
    # wraps the policy's new_event_loop, so asyncio.run's loop is
    # watched on a real node exactly as under pytest (no-op unless
    # PBFT_SANITIZE=loop is set)
    from . import sanitize

    sanitize.install()
    asyncio.run(run_node(args))


if __name__ == "__main__":
    main()
