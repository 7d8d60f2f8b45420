"""Transport layer: how replicas and clients exchange wire bytes.

Reference parity: L4 in SURVEY.md §1 — fire-and-forget HTTP POST with a
path per message kind (consensusInterface.go) and an O(n) serial unicast
Broadcast (node.go:107-129). Redesigned:

- ``base.Transport`` — a minimal async interface (send/broadcast/inbox).
- ``local.LocalNetwork`` — in-process committee: every node is an asyncio
  queue; supports fault injection (drop/delay/duplicate/partition) — the
  simulated transport the reference never had (its "cluster" was 4
  localhost processes, run.bat:19-26) and the substrate for the
  100-replica benchmark configs.
- ``tcp.TcpTransport`` — length-prefixed JSON over asyncio TCP with
  persistent reconnecting connections and bounded outboxes, for real
  multi-process committees (see node.py / launch.py).
- ``grpc.GrpcTransport`` — persistent client-streaming RPCs over HTTP/2
  (the DCN path, SURVEY.md §2.3); gRPC owns reconnects and flow control.
  Imported lazily (``--transport grpc``) so grpcio stays optional.
"""

from .base import Transport  # noqa: F401
from .local import LocalEndpoint, LocalNetwork  # noqa: F401
