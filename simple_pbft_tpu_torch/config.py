"""Committee configuration.

Replaces the reference's hard-coded everything: the 4-entry NodeTable
(node.go:60-65), f=1 duplicated in two files (node.go:45, pbft_impl.go:37),
the fixed primary "MainNode" (node.go:68), and the magic view id
(node.go:55). Here the committee is data: an ordered replica list, f derived
from it, per-replica Ed25519 public keys, rotating primary, and the
batching / checkpoint / watermark knobs the reference lacks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional, Tuple

from .crypto import ed25519_cpu


@dataclass(frozen=True)
class CommitteeConfig:
    """Static description of a PBFT committee."""

    replica_ids: Tuple[str, ...]
    pubkeys: Dict[str, bytes]  # replica/client id -> 32-byte Ed25519 pubkey
    checkpoint_interval: int = 64
    watermark_window: int = 256  # H = h + watermark_window
    max_batch: int = 256  # max client requests per block
    view_timeout: float = 2.0  # seconds before a replica suspects the primary
    verify_signatures: bool = True
    # BLS quorum-certificate mode (BASELINE config 4): votes carry BLS
    # shares and go only to the primary, which aggregates 2f+1 into a
    # QuorumCert verified with ONE pairing check — O(n) messages per phase
    # instead of O(n^2), and certificates that fit in a QC instead of
    # 2f+1 embedded votes.
    qc_mode: bool = False
    bls_pubkeys: Dict[str, bytes] = field(default_factory=dict)  # 192-byte G2
    # Speculative pipelined execution: execute blocks at
    # PREPARED against a forkable app state and reply early with a
    # signed speculative mark; roll back any speculated suffix whose
    # digest loses on view change (consensus/speculation.py). Commit
    # latency is pipeline depth, not crypto, and speculation collapses
    # the client-visible half of it — on by default, disable to A/B.
    speculative: bool = True
    # X25519 key-exchange pubkeys (replicas AND clients) for the MAC'd
    # reply fast path (crypto/mac.py); pairs lacking either key fall
    # back to Ed25519-signed replies
    kx_pubkeys: Dict[str, bytes] = field(default_factory=dict)
    # Live membership reconfiguration: the configuration
    # epoch, bumped each time a committed Reconfig op activates at a
    # checkpoint boundary. Epoch 0 is the boot committee. ``admin_ids``
    # names the identities whose signed __reconfig__ operations are
    # honored — empty means reconfiguration is disabled (every reconfig
    # op executes as a denied no-op), the safe default.
    epoch: int = 0
    admin_ids: Tuple[str, ...] = ()
    # Network address book (id -> (host, port)) for socket transports.
    # Rides config_doc so a reconfiguration-added member is REACHABLE,
    # not just named: epoch activation and client adoption push these
    # into the transport peer maps (transport.base.update_peer_book).
    # Empty for id-routed (local) committees, where reachability is not
    # address-based. Deterministic: boot entries come from the shared
    # deployment document, later ones from committed reconfig content.
    addrs: Dict[str, Tuple[str, int]] = field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.replica_ids)

    @property
    def f(self) -> int:
        """Max Byzantine replicas: n >= 3f + 1."""
        return (self.n - 1) // 3

    @property
    def quorum(self) -> int:
        """2f+1 — prepare/commit certificate size (distinct senders,
        counting the replica's own vote; Castro-Liskov quorums, vs. the
        reference's 2f-others formulation at pbft_impl.go:212,227)."""
        return 2 * self.f + 1

    @property
    def weak_quorum(self) -> int:
        """f+1 — at least one honest replica (client reply matching)."""
        return self.f + 1

    @property
    def repliers(self) -> int:
        """Designated-replier set size: f+1 matching replies is what the
        client NEEDS, but transmitting exactly f+1 leaves zero slack — a
        single dropped reply (or one slow designee) then costs a full
        client timeout (measured: 2% message loss at n=64 pushed reply
        p50 to the whole 30 s retry period). A few spares make the
        common case loss-tolerant while still saving the n-f-1 wasted
        signs/sends the rotation exists to avoid."""
        return min(self.n, self.weak_quorum + max(1, self.f // 4))

    @property
    def spec_repliers(self) -> int:
        """Designated SPECULATIVE-replier set size. A speculative answer
        needs 2f+1 matching marks (not f+1 — the quorum-intersection
        argument that makes a spec answer final-safe needs 2f+1
        preparers on record), so the rotation window is quorum plus the
        same loss-tolerance spares the final-reply rotation carries."""
        return min(self.n, self.quorum + max(1, self.f // 4))

    def primary(self, view: int) -> str:
        """Round-robin primary rotation (the reference sketched this in its
        dead view.go:13-31 but never wired it)."""
        return self.replica_ids[view % self.n]

    def pubkey(self, node_id: str) -> Optional[bytes]:
        return self.pubkeys.get(node_id)

    def bls_pubkey(self, node_id: str) -> Optional[bytes]:
        return self.bls_pubkeys.get(node_id)


def config_doc(cfg: CommitteeConfig) -> Dict[str, object]:
    """Deterministic JSON-ready description of the MEMBERSHIP state (the
    part a reconfiguration changes): epoch, ordered replica ids, and the
    key tables, hex-encoded with sorted ids. This block rides inside
    every checkpoint snapshot (replica._checkpoint_snapshot) so a
    state-transferred joiner restores the exact committee its peers run
    — and it is what ConfigReply ships to stale clients."""
    return {
        "epoch": cfg.epoch,
        "replica_ids": list(cfg.replica_ids),
        "admin_ids": list(cfg.admin_ids),
        "pubkeys": {k: v.hex() for k, v in sorted(cfg.pubkeys.items())},
        "bls_pubkeys": {
            k: v.hex() for k, v in sorted(cfg.bls_pubkeys.items())
        },
        "kx_pubkeys": {
            k: v.hex() for k, v in sorted(cfg.kx_pubkeys.items())
        },
        "addrs": {
            k: [v[0], v[1]] for k, v in sorted(cfg.addrs.items())
        },
    }


def config_from_doc(base: CommitteeConfig, doc: Dict[str, Any]) -> CommitteeConfig:
    """Rebuild a CommitteeConfig from a config_doc, inheriting every
    non-membership knob (timeouts, batching, qc_mode, ...) from
    ``base``. Raises ValueError on a malformed doc — snapshot installs
    must reject garbage atomically."""
    import dataclasses

    try:
        ids = tuple(str(i) for i in doc["replica_ids"])
        if not ids:
            raise ValueError("empty replica_ids")
        return dataclasses.replace(
            base,
            replica_ids=ids,
            admin_ids=tuple(str(i) for i in doc.get("admin_ids", [])),
            pubkeys={
                str(k): bytes.fromhex(v)
                for k, v in dict(doc["pubkeys"]).items()
            },
            bls_pubkeys={
                str(k): bytes.fromhex(v)
                for k, v in dict(doc.get("bls_pubkeys", {})).items()
            },
            kx_pubkeys={
                str(k): bytes.fromhex(v)
                for k, v in dict(doc.get("kx_pubkeys", {})).items()
            },
            addrs={
                str(k): (str(v[0]), int(v[1]))
                for k, v in dict(doc.get("addrs", {})).items()
            },
            epoch=int(doc["epoch"]),
        )
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"bad config doc: {e}") from None


def apply_reconfig(
    cfg: CommitteeConfig,
    add: Dict[str, Dict[str, str]],
    remove: Iterable[str],
) -> CommitteeConfig:
    """The committed membership change: remove ids, append new replicas
    (sorted, after the survivors — rotation order must be identical on
    every replica), bump the epoch. ``add`` maps new id -> {"pub": hex,
    optional "bls": hex, optional "kx": hex, optional "addr":
    "host:port" — required in practice for socket-transport committees,
    or the new member is named but unreachable}. Raises ValueError when the
    result would be degenerate (fewer than 4 replicas — f would hit 0
    and the committee could no longer survive ANY fault) or malformed."""
    import dataclasses

    removes = set(remove)
    unknown = removes - set(cfg.replica_ids)
    if unknown:
        raise ValueError(f"cannot remove non-members {sorted(unknown)}")
    dup = set(add) & (set(cfg.replica_ids) - removes)
    if dup:
        raise ValueError(f"cannot add existing members {sorted(dup)}")
    survivors = set(cfg.replica_ids) - removes
    # subtract SURVIVORS, not current members: remove+add of the same id
    # (key rotation) must re-add it, not silently drop the member
    new_ids = tuple(i for i in cfg.replica_ids if i not in removes) + tuple(
        sorted(set(add) - survivors)
    )
    if len(new_ids) < 4:
        raise ValueError("resulting committee below n=4")
    pubkeys = dict(cfg.pubkeys)
    bls = dict(cfg.bls_pubkeys)
    kx = dict(cfg.kx_pubkeys)
    # removed members keep their address entry: retirees keep serving
    # state-transfer chunks and config lookups until shut down
    addrs = dict(cfg.addrs)
    for rid, keys in add.items():
        pubkeys[rid] = bytes.fromhex(keys["pub"])
        if keys.get("bls"):
            bls[rid] = bytes.fromhex(keys["bls"])
        if keys.get("kx"):
            kx[rid] = bytes.fromhex(keys["kx"])
        if keys.get("addr"):
            host, _, port = str(keys["addr"]).rpartition(":")
            if not host:
                raise ValueError(f"bad addr for {rid} (want host:port)")
            addrs[rid] = (host, int(port))
    if cfg.qc_mode and any(r not in bls for r in new_ids):
        raise ValueError("qc_mode committee needs a bls key per member")
    return dataclasses.replace(
        cfg,
        replica_ids=new_ids,
        pubkeys=pubkeys,
        bls_pubkeys=bls,
        kx_pubkeys=kx,
        addrs=addrs,
        epoch=cfg.epoch + 1,
    )


@dataclass
class KeyPair:
    seed: bytes
    pub: bytes

    @staticmethod
    def generate(seed: bytes) -> "KeyPair":
        return KeyPair(seed=seed, pub=ed25519_cpu.public_key(seed))


def make_test_committee(
    n: int = 4, clients: int = 1, **overrides: Any
) -> Tuple[CommitteeConfig, Dict[str, KeyPair]]:
    """Deterministic committee for tests/benchmarks: replicas r0..r{n-1},
    clients c0..c{clients-1}, keys derived from ids."""
    ids = tuple(f"r{i}" for i in range(n))
    keys: Dict[str, KeyPair] = {}
    for name in list(ids) + [f"c{i}" for i in range(clients)]:
        seed = (name.encode() * 32)[:32]
        keys[name] = KeyPair.generate(seed)
    bls_pubkeys: Dict[str, bytes] = {}
    if overrides.get("qc_mode"):
        from .crypto import bls

        for rid in ids:
            _, bls_pubkeys[rid] = bls.keygen(keys[rid].seed)
    from .crypto import mac as mac_mod

    cfg = CommitteeConfig(
        replica_ids=ids,
        pubkeys={k: v.pub for k, v in keys.items()},
        # test committees trust their generated clients as reconfig
        # admins (production deployments name admin_ids explicitly)
        admin_ids=overrides.pop(
            "admin_ids", tuple(f"c{i}" for i in range(clients))
        ),
        bls_pubkeys=overrides.pop("bls_pubkeys", bls_pubkeys),
        kx_pubkeys=overrides.pop(
            "kx_pubkeys",
            # empty when no X25519 backend: everyone signs replies instead
            {
                k: kx
                for k, v in keys.items()
                if (kx := mac_mod.kx_pubkey(v.seed)) is not None
            },
        ),
        **overrides,
    )
    return cfg, keys
