"""Deployment descriptor: committees as data, processes as peers.

Parity target: the reference's entire deployment story is a hard-coded
4-entry NodeTable (node.go:60-65: localhost:1111-1114) plus run.bat. Here
a deployment is a JSON document shared by every node and client:

    {
      "options": {"checkpoint_interval": 64, "view_timeout": 2.0, ...},
      "replicas": {"r0": {"host": "127.0.0.1", "port": 7000,
                           "pubkey": "<hex>",
                           "kx_pubkey": "<hex>"}, ...},
      "clients":  {"c0": {"host": "127.0.0.1", "port": 7500,
                           "pubkey": "<hex>",
                           "kx_pubkey": "<hex>"}, ...}
    }

``kx_pubkey`` (X25519, optional) enables MAC-authenticated replies
between that node and its peers (crypto/mac.py); entries lacking it
fall back to Ed25519-signed replies.

Private key seeds live in separate per-node files (`<id>.seed`, 32 raw
bytes) so the shared document carries no secrets.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Tuple

from .config import CommitteeConfig, KeyPair

_OPTION_FIELDS = (
    "checkpoint_interval",
    "watermark_window",
    "max_batch",
    "view_timeout",
    "verify_signatures",
    # identities whose signed __reconfig__ operations are authorized
    # (JSON list in the document; empty/absent = reconfiguration
    # disabled). Named explicitly per deployment — unlike
    # make_test_committee, a real deployment trusts no client by default.
    "admin_ids",
)


def _cfg_options(options: Dict) -> Dict:
    out = {k: v for k, v in options.items() if k in _OPTION_FIELDS}
    if "admin_ids" in out:
        ids = out["admin_ids"]
        if isinstance(ids, str):
            # a bare "c0" would otherwise iterate into ('c', '0') —
            # silently authorizing nobody and denying the intended admin
            ids = (ids,)
        out["admin_ids"] = tuple(str(i) for i in ids)
    return out


@dataclass
class Deployment:
    cfg: CommitteeConfig
    addresses: Dict[str, Tuple[str, int]]  # every node and client

    def addr(self, node_id: str) -> Tuple[str, int]:
        return self.addresses[node_id]

    def peers_for(self, node_id: str) -> Dict[str, Tuple[str, int]]:
        return {k: v for k, v in self.addresses.items() if k != node_id}


def generate(
    out_dir: str,
    n: int = 4,
    clients: int = 1,
    host: str = "127.0.0.1",
    base_port: int = 7000,
    **options,
) -> Deployment:
    """Create a fresh deployment: committee.json + per-node seed files."""
    os.makedirs(out_dir, exist_ok=True)
    doc: Dict = {"options": options, "replicas": {}, "clients": {}}
    addresses: Dict[str, Tuple[str, int]] = {}
    pubkeys: Dict[str, bytes] = {}
    names = [(f"r{i}", "replicas", base_port + i) for i in range(n)] + [
        (f"c{i}", "clients", base_port + 500 + i) for i in range(clients)
    ]
    from .crypto import mac as mac_mod

    kx_pubkeys: Dict[str, bytes] = {}
    for name, kind, port in names:
        seed = os.urandom(32)
        kp = KeyPair.generate(seed)
        kx = mac_mod.kx_pubkey(seed)
        with open(os.path.join(out_dir, f"{name}.seed"), "wb") as fh:
            fh.write(seed)
        doc[kind][name] = {
            "host": host,
            "port": port,
            "pubkey": kp.pub.hex(),
        }
        if kx is not None:
            # X25519 key-exchange pubkey: enables MAC'd replies (the
            # point-to-point fast path, crypto/mac.py); derived from the
            # same seed so the per-node secret material stays one file.
            # Omitted when no X25519 backend exists — replies then fall
            # back to Ed25519 signatures (mac.kx_available).
            doc[kind][name]["kx_pubkey"] = kx.hex()
            kx_pubkeys[name] = kx
        addresses[name] = (host, port)
        pubkeys[name] = kp.pub
    with open(os.path.join(out_dir, "committee.json"), "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
    cfg = CommitteeConfig(
        replica_ids=tuple(sorted(doc["replicas"])),
        pubkeys=pubkeys,
        kx_pubkeys=kx_pubkeys,
        # boot address book rides the config (and thus every checkpoint
        # snapshot): joiners and reconfigurations inherit reachability,
        # not just membership (transport.base.update_peer_book)
        addrs=dict(addresses),
        **_cfg_options(options),
    )
    return Deployment(cfg=cfg, addresses=addresses)


def load(path: str) -> Deployment:
    """Load committee.json (raises ValueError on malformed documents)."""
    with open(path) as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict):
        raise ValueError("deployment must be a JSON object")
    replicas = doc.get("replicas")
    clients = doc.get("clients", {})
    options = doc.get("options", {})
    if not isinstance(replicas, dict) or not replicas:
        raise ValueError("deployment needs a non-empty 'replicas' map")
    addresses: Dict[str, Tuple[str, int]] = {}
    pubkeys: Dict[str, bytes] = {}
    kx_pubkeys: Dict[str, bytes] = {}
    for kind in (replicas, clients):
        for name, ent in kind.items():
            if not isinstance(ent, dict):
                raise ValueError(f"bad node entry: {name}")
            try:
                addresses[name] = (str(ent["host"]), int(ent["port"]))
                pubkeys[name] = bytes.fromhex(ent["pubkey"])
                # optional (older documents lack it): its absence just
                # falls the affected pairs back to Ed25519-signed replies
                if "kx_pubkey" in ent:
                    kx_pubkeys[name] = bytes.fromhex(ent["kx_pubkey"])
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(f"bad node entry {name}: {e}") from None
    cfg = CommitteeConfig(
        replica_ids=tuple(sorted(replicas)),
        pubkeys=pubkeys,
        kx_pubkeys=kx_pubkeys,
        addrs=dict(addresses),
        **_cfg_options(options),
    )
    return Deployment(cfg=cfg, addresses=addresses)


def read_seed(deploy_dir: str, node_id: str) -> bytes:
    with open(os.path.join(deploy_dir, f"{node_id}.seed"), "rb") as fh:
        seed = fh.read()
    if len(seed) != 32:
        raise ValueError(f"seed file for {node_id} must be 32 bytes")
    return seed
