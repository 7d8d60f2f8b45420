"""Wire message schema + canonical serialization.

Parity target: the reference's message structs in
``pbft/consensus/pbft_msg_types.go:3-38`` (RequestMsg, PrePrepareMsg,
VoteMsg{Prepare,Commit}, ReplyMsg; JSON wire format). Redesigned here:

- Every protocol message carries ``sender`` and an Ed25519 ``sig`` over its
  canonical encoding (the reference has no signatures at all — the author's
  own gap list, 需要改进的地方.md:17, calls for exactly this).
- Pre-prepares carry a *block* (batch) of client requests, not a single
  request, so one consensus instance orders many requests (the reference's
  one-request-per-instance design is its throughput ceiling, node.go:21).
- Additional message kinds the reference lacks: Checkpoint, ViewChange,
  NewView (its ``view.go`` is dead code).

Canonical encoding = JSON with sorted keys and compact separators, bytes as
lowercase hex. The signing payload is the canonical encoding with the ``sig``
field blanked, so signatures are over a deterministic byte string.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field, fields
from typing import Any, Callable, ClassVar, Dict, List, Optional, Tuple, Type

# ---------------------------------------------------------------------------
# Canonical encoding helpers
# ---------------------------------------------------------------------------


_native_encode: Optional[Callable[[Any], Optional[bytes]]] = None
_native_checked = False


def canonical_json(obj: Any) -> bytes:
    """Deterministic JSON bytes: sorted keys, no whitespace, ensure-ascii.

    This is both the wire format and the digest/signing preimage, so the
    native encoder (native/canonjson.cpp) must be byte-identical to the
    json module — it self-tests at load, covers exactly the wire subset,
    and returns None (-> json fallback) for anything else. Lazy-bound so
    importing messages never forces a native build."""
    global _native_encode, _native_checked
    if not _native_checked:
        _native_checked = True
        try:
            from .native import canonjson_encode

            _native_encode = canonjson_encode
        except Exception:  # noqa: BLE001 — any native issue: pure json
            _native_encode = None
    if _native_encode is not None:
        out = _native_encode(obj)
        if out is not None:
            return out
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


MAX_NESTING = 16


def _check_depth(obj: Any, limit: int = MAX_NESTING) -> None:
    """Iteratively bound container nesting so a hostile packet can't drive
    json.dumps (signing/digest paths) into RecursionError later."""
    stack = [(obj, 0)]
    while stack:
        o, d = stack.pop()
        if d > limit:
            raise ValueError("message nesting too deep")
        if isinstance(o, dict):
            stack.extend((v, d + 1) for v in o.values())
        elif isinstance(o, list):
            stack.extend((v, d + 1) for v in o)


# ---------------------------------------------------------------------------
# Base message
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type["Message"]] = {}


@dataclass
class Message:
    """Base class: every message has a kind, a sender, and a signature."""

    KIND: ClassVar[str] = "message"

    sender: str = ""
    sig: str = ""  # hex Ed25519 signature over signing_payload()

    # per-class decode caches, populated lazily by the classmethods
    # below (ClassVar so the dataclass machinery never sees them as
    # fields; Optional so mypy accepts the lazy-init protocol)
    _FIELD_SPECS: ClassVar[
        Optional[List[Tuple[str, Optional[type], type]]]
    ] = None
    _DEFAULT_SPEC: ClassVar[
        Optional[
            Tuple[Dict[str, Any], Tuple[Tuple[str, Callable[[], Any]], ...]]
        ]
    ] = None

    def __init_subclass__(cls, **kw: Any) -> None:
        super().__init_subclass__(**kw)
        _REGISTRY[cls.KIND] = cls

    def __setattr__(self, name: str, value: Any) -> None:
        # any public-field mutation invalidates the cached signing
        # payload (below) — except the authenticator fields ``sig`` and
        # ``mac``, which every payload blanks by construction (so
        # signing/tagging a message keeps its own cache warm). Fast path
        # first: during dataclass __init__ no cache exists yet, and this
        # runs per field per decoded message on the hot path.
        d = self.__dict__
        if "_payload" in d and name != "sig" and name != "mac" and name[0] != "_":
            del d["_payload"]
        d[name] = value

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """SHALLOW field dict (nested blocks/proofs are stored as plain
        JSON-ready dicts already, so there is nothing to convert —
        dataclasses.asdict's recursive deep copy measured ~15% of a
        view-change storm's CPU). Callers must not mutate nested
        structures of the returned dict; top-level keys are a fresh dict
        and safe to adjust. Private attrs (payload cache, _validated
        memo) are excluded."""
        d = {
            k: v for k, v in self.__dict__.items() if not k.startswith("_")
        }
        d["kind"] = self.KIND
        return d

    def to_wire(self) -> bytes:
        return canonical_json(self.to_dict())

    @staticmethod
    def from_dict(
        d: Dict[str, Any], *, _depth_checked: bool = False
    ) -> "Message":
        """Decode + validate. Raises ValueError on anything malformed —
        the single exception transports/runtimes guard against, so one
        Byzantine packet can never crash a replica with a surprise type.

        ``_depth_checked=True`` skips the nesting-depth DoS guard: for
        certificate internals the whole wire message was depth-checked
        once on arrival, and re-walking every nested subtree per decode
        is O(size x depth) (measured ~18% of a view-change storm)."""
        if not isinstance(d, dict):
            raise ValueError("message must be a JSON object")
        if not _depth_checked:
            _check_depth(d)
        d = dict(d)
        kind = d.pop("kind", None)
        # kind must be hashable AND known: a {"kind": [...]} packet must
        # raise ValueError like every other malformation, not TypeError
        # from the dict lookup (found by the wire fuzzer)
        cls = _REGISTRY.get(kind) if isinstance(kind, str) else None
        if cls is None:
            raise ValueError(f"unknown message kind: {kind!r}")
        return cls._build(d)

    @classmethod
    def _field_specs(cls) -> List[Tuple[str, Optional[type], type]]:
        """(name, want, elem) per dataclass field, computed once per class
        — decode runs per wire message on the replica hot path; re-parsing
        f.type strings there cost ~10% of a committee's CPU."""
        specs = cls.__dict__.get("_FIELD_SPECS")
        if specs is None:
            specs = []
            for f in fields(cls):
                # under `from __future__ import annotations` f.type is
                # the annotation STRING (typeshed says str | type, so
                # normalize before parsing it)
                ftype = f.type if isinstance(f.type, str) else f.type.__name__
                want = {"int": int, "str": str}.get(ftype.split("[")[0])
                if ftype.startswith("List[str]"):
                    elem: type = str
                elif ftype.startswith("List[int]"):
                    elem = int
                else:
                    elem = dict
                specs.append((f.name, want, elem))
            cls._FIELD_SPECS = specs
        return specs

    @classmethod
    def _default_spec(
        cls,
    ) -> Tuple[Dict[str, Any], Tuple[Tuple[str, Callable[[], Any]], ...]]:
        """(plain-defaults dict, [(name, factory)]) per class, computed
        once — lets _build construct instances through __dict__ directly
        instead of the dataclass __init__/__setattr__ chain (one dict
        update vs ~10 attribute sets per decoded message; decode volume
        is O(n^2) votes per committed request)."""
        spec = cls.__dict__.get("_DEFAULT_SPEC")
        if spec is None:
            import dataclasses as _dc

            plain: Dict[str, Any] = {}
            factories = []
            for f in fields(cls):
                if f.default is not _dc.MISSING:
                    plain[f.name] = f.default
                elif f.default_factory is not _dc.MISSING:
                    factories.append((f.name, f.default_factory))
                else:
                    # a default-less field would silently decode as None
                    # (the 'surprise type' class from_dict promises can
                    # never reach a replica) — fail loudly at class
                    # first-use instead
                    raise TypeError(
                        f"{cls.__name__}.{f.name} needs a default: wire "
                        "messages are built field-by-field from hostile "
                        "input"
                    )
            cls._DEFAULT_SPEC = spec = (plain, tuple(factories))
        return spec

    @classmethod
    def _build(cls, d: Dict[str, Any]) -> "Message":
        kw = {}
        for name, want, elem in cls._field_specs():
            if name not in d:
                continue
            v = d[name]
            if want is int and (not isinstance(v, int) or isinstance(v, bool)):
                raise ValueError(f"{cls.KIND}.{name}: expected int")
            if want is str and not isinstance(v, str):
                raise ValueError(f"{cls.KIND}.{name}: expected str")
            if want is None:
                if not isinstance(v, list) or not all(
                    isinstance(e, elem)
                    and not (elem is int and isinstance(e, bool))
                    for e in v
                ):
                    raise ValueError(
                        f"{cls.KIND}.{name}: expected list of "
                        f"{elem.__name__}"
                    )
            kw[name] = v
        obj = cls.__new__(cls)
        plain, factories = cls._default_spec()
        od = obj.__dict__
        od.update(plain)
        for name, fac in factories:
            od[name] = fac()
        od.update(kw)
        return obj

    # Per-type wire cap. Data-plane messages stay small; view-change-class
    # certificates (ViewChange/NewView) override with a larger cap because
    # their prepared proofs embed whole request blocks — without the
    # override a loaded primary's failover message would be undeliverable.
    MAX_WIRE_BYTES: ClassVar[int] = 8 * 1024 * 1024
    # absolute pre-parse bound (the largest any subclass allows)
    MAX_CERT_WIRE_BYTES: ClassVar[int] = 256 * 1024 * 1024

    @staticmethod
    def from_wire(raw: bytes) -> "Message":
        if len(raw) > Message.MAX_CERT_WIRE_BYTES:
            raise ValueError("message too large")
        if len(raw) > Message.MAX_WIRE_BYTES:
            # Fast pre-parse reject: only certificate kinds may exceed the
            # data-plane cap. A substring scan is ~100x cheaper than
            # json.loads on a hostile 256 MiB frame; a data-plane message
            # smuggling the substring in a string field still fails the
            # authoritative post-parse per-type check below.
            if (
                b'"kind": "viewchange"' not in raw
                and b'"kind": "newview"' not in raw
                and b'"kind": "blockreply"' not in raw
                and b'"kind":"viewchange"' not in raw
                and b'"kind":"newview"' not in raw
                and b'"kind":"blockreply"' not in raw
            ):
                raise ValueError("message too large for its type")
        try:
            d = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError, RecursionError) as e:
            raise ValueError(f"undecodable message: {e}") from None
        # The nesting-depth bound holds for EVERY frame (a size- or
        # version-dependent skip here once made the same bytes valid
        # standalone but invalid embedded in a NewView — a re-poisonable
        # view-change stall). The Python walk is only needed when it
        # could possibly fire: depth cannot exceed the number of opening
        # brackets, so a C-speed byte count (~0.4 us) proves most
        # data-plane frames shallow and skips the ~24 us walk without
        # weakening the bound (measured: the walk was ~8% of committee
        # CPU at n=100).
        shallow = (raw.count(b"[") + raw.count(b"{")) <= MAX_NESTING
        msg = Message.from_dict(d, _depth_checked=shallow)
        if len(raw) > type(msg).MAX_WIRE_BYTES:
            raise ValueError("message too large for its type")
        return msg

    # -- signing ------------------------------------------------------------

    #: authenticator fields blanked out of every signing payload (a tag
    #: cannot cover itself); subclasses with additional authenticators
    #: extend this (Reply adds "mac") — __setattr__'s invalidation
    #: exemptions must stay in sync with the union of these.
    _AUTH_FIELDS: ClassVar[Tuple[str, ...]] = ("sig",)

    def signing_payload(self) -> bytes:
        """Canonical encoding with the authenticator fields blanked.

        Cached after first computation and invalidated by __setattr__ on
        any payload-relevant field mutation. The cache is authenticator-
        independent by construction, and a NEW-VIEW's 2f+1 embedded
        certificates re-canonicalizing at every receiver measured ~10%
        of a storm's CPU."""
        cached = self.__dict__.get("_payload")
        if cached is None:
            d = self.to_dict()
            for f_ in self._AUTH_FIELDS:
                d[f_] = ""
            cached = canonical_json(d)
            self.__dict__["_payload"] = cached
        return cached

    def payload_digest(self) -> str:
        """SHA-256 hex digest of the signing payload (sig-independent).

        Mirrors the reference's ``digest(obj)`` = SHA-256 over JSON
        (pbft_impl.go:235-243, utils/utils.go:13-17). Named
        ``payload_digest`` because vote messages carry a ``digest`` *field*
        (the proposal digest they vote on).
        """
        return sha256_hex(self.signing_payload())


# ---------------------------------------------------------------------------
# Client-facing messages
# ---------------------------------------------------------------------------


@dataclass
class Request(Message):
    """Client request. Reference: RequestMsg (pbft_msg_types.go:3-8).

    ``timestamp`` is a client-chosen monotonic nonce (the reference used wall
    clock); (client_id, timestamp) identifies a request for reply matching
    and at-most-once execution.

    ``ack`` is the client's signed retransmission floor: every own
    timestamp <= ack is RESOLVED — answered (f+1 matches collected) or
    abandoned (retries exhausted) — so the client will never retransmit
    it. It is NOT proof of execution: an abandoned timestamp may or may
    not have executed. Replicas use the floor to fold per-client
    replay state (reply cache -> watermark) without ever folding a
    timestamp that may still be in flight — a PIPELINED client (many
    concurrent submits over one identity) otherwise races the checkpoint
    fold: at high block rates the fold's seq-based horizon passes in
    milliseconds, and a dropped-then-retried lower timestamp comes back
    SUPERSEDED instead of executing. The floor rides inside executed
    blocks, so every replica folds identically (checkpoint determinism).
    """

    KIND: ClassVar[str] = "request"

    client_id: str = ""
    timestamp: int = 0
    operation: str = ""
    ack: int = 0


@dataclass
class Reply(Message):
    """Replica -> client reply. Reference: ReplyMsg (pbft_msg_types.go:10-16).

    Unlike the reference (which sends replies to the *primary* and never
    forwards them — node.go:132-147,269-274), replies go straight to the
    client, which collects f+1 matching results.
    """

    KIND: ClassVar[str] = "reply"

    view: int = 0
    seq: int = 0
    client_id: str = ""
    timestamp: int = 0
    result: str = ""
    #: 1 = the request's timestamp fell at/below a folded checkpoint
    #: watermark with no cached reply: the operation was NOT (re-)applied
    #: and ``result`` carries no application data. A dedicated field, not
    #: an in-band reserved result string — nothing stops an application
    #: from legitimately storing/returning any string.
    superseded: int = 0
    #: 1 = SPECULATIVE: the executing replica applied the
    #: block at PREPARED, before the commit certificate formed. The mark
    #: is signed (it rides the payload like every field), so a client
    #: can count 2f+1 matching speculative replies as a fast answer —
    #: 2f+1 speculators means 2f+1 replicas PREPARED the slot, and by
    #: quorum intersection no future view can install a different block
    #: there — while final (spec=0) replies from the same replicas
    #: upgrade, never double-count (client._on_reply dedupes per sender
    #: with the stricter mark winning).
    spec: int = 0
    #: committee configuration epoch the executing replica was in
    #:. A client holding a
    #: stale address book sees epoch > its own in any reply and
    #: re-resolves the committee via ConfigFetch instead of timing out
    #: against removed replicas. Deterministic across honest replicas:
    #: epoch activation is a function of the agreed executed history.
    epoch: int = 0
    #: hex HMAC-SHA256 over signing_payload() under the per-(replica,
    #: client) shared key (crypto/mac.py) — the point-to-point fast path;
    #: either ``mac`` or ``sig`` authenticates a reply, never both needed.
    mac: str = ""

    #: both authenticators blank out of the payload so sig and mac attest
    #: the same bytes and either can authenticate interchangeably
    _AUTH_FIELDS: ClassVar[Tuple[str, ...]] = ("sig", "mac")


# ---------------------------------------------------------------------------
# Consensus phase messages
# ---------------------------------------------------------------------------


@dataclass
class PrePrepare(Message):
    """Primary's ordering proposal. Reference: PrePrepareMsg
    (pbft_msg_types.go:18-23) — extended to carry a *block* of requests.

    ``digest`` covers the block (list of request dicts) canonically, so
    prepares/commits vote on the block content without re-shipping it.
    """

    KIND: ClassVar[str] = "preprepare"

    view: int = 0
    seq: int = 0
    digest: str = ""
    block: List[Dict[str, Any]] = field(default_factory=list)

    def signing_payload(self) -> bytes:
        """Sign over (view, seq, digest) with the block DETACHED — the
        digest binds the block content (block_digest is enforced at every
        admission point: state.Instance.on_pre_prepare, the view-change
        validators, and the block-fetch fill path). Castro-Liskov §2.4
        does the same ("the big message is not included"): it lets
        view-change certificates ship digest-only pre-prepares and lets
        replicas refill blocks from their store or a fetch without
        breaking the primary's signature."""
        d = self.to_dict()
        d["sig"] = ""
        d["block"] = []
        return canonical_json(d)

    @staticmethod
    def block_digest(block: List[Dict[str, Any]]) -> str:
        return sha256_hex(canonical_json(block))


@dataclass
class Prepare(Message):
    """Phase-2 vote. Reference: VoteMsg with MsgType=PrepareMsg
    (pbft_msg_types.go:25-38).

    In QC mode (config.qc_mode) the vote additionally carries
    ``bls_share`` — a hex G1 BLS signature over ``qc_payload(...)`` —
    and goes only to the primary, which aggregates 2f+1 shares into a
    ``QuorumCert``."""

    KIND: ClassVar[str] = "prepare"

    view: int = 0
    seq: int = 0
    digest: str = ""
    bls_share: str = ""


@dataclass
class Commit(Message):
    """Phase-3 vote. Reference: VoteMsg with MsgType=CommitMsg
    (pbft_msg_types.go:25-38). ``bls_share`` as in Prepare."""

    KIND: ClassVar[str] = "commit"

    view: int = 0
    seq: int = 0
    digest: str = ""
    bls_share: str = ""


def qc_payload(phase: str, view: int, seq: int, digest: str) -> bytes:
    """The byte string every BLS share and aggregate signs for one QC."""
    return canonical_json(
        {"digest": digest, "phase": phase, "seq": seq, "view": view}
    )


@dataclass
class QuorumCert(Message):
    """Aggregate certificate for one phase of one slot (QC mode).

    2f+1 distinct replicas' BLS shares over ``qc_payload(phase, view,
    seq, digest)``, aggregated to one G1 point — the whole certificate
    verifies with ONE pairing check (BASELINE config 4), and it replaces
    the O(n^2) all-to-all vote broadcast with primary-relayed O(n)
    messages. Self-certifying: any replica may relay it.
    """

    KIND: ClassVar[str] = "qc"

    phase: str = ""  # "prepare" | "commit"
    view: int = 0
    seq: int = 0
    digest: str = ""
    signers: List[str] = field(default_factory=list)
    agg_sig: str = ""  # hex, 96-byte G1 point

    def payload(self) -> bytes:
        return qc_payload(self.phase, self.view, self.seq, self.digest)


# ---------------------------------------------------------------------------
# Checkpoint / view change (absent from the reference; its author's notes
# 需要改进的地方.md:31-69 specify them as the missing pieces)
# ---------------------------------------------------------------------------


@dataclass
class Checkpoint(Message):
    """Periodic proof of execution state at a sequence number.

    In QC mode ``bls_share`` (hex G1 signature over
    ``qc_payload("checkpoint", 0, seq, state_digest)``) lets any replica
    aggregate the 2f+1 matching checkpoints it collects into ONE
    CheckpointQC — so a VIEW-CHANGE's proof of h is a single aggregate
    instead of 2f+1 signed messages."""

    KIND: ClassVar[str] = "checkpoint"

    seq: int = 0
    state_digest: str = ""
    bls_share: str = ""


@dataclass
class ViewChange(Message):
    """VIEW-CHANGE: replica's evidence when moving to a new view.

    - ``stable_seq``: last stable checkpoint sequence (h).
    - ``checkpoint_proof``: 2f+1 Checkpoint dicts proving h is stable.
    - ``prepared_proofs``: for each seq > h this replica prepared, the
      pre-prepare dict plus 2f+1 matching prepare dicts (the certificate
      ``Instance.prepared_proof`` emits).
    """

    KIND: ClassVar[str] = "viewchange"
    MAX_WIRE_BYTES: ClassVar[int] = 64 * 1024 * 1024

    new_view: int = 0
    stable_seq: int = 0
    checkpoint_proof: List[Dict[str, Any]] = field(default_factory=list)
    prepared_proofs: List[Dict[str, Any]] = field(default_factory=list)

    def signing_payload(self) -> bytes:
        """Sign with the checkpoint proof DETACHED (the same move as
        PrePrepare's detached block). The proof is self-certifying —
        every embedded Checkpoint carries its own Ed25519 signature and
        a CheckpointQC its own BLS aggregate, all re-verified by the
        receiver — while the CLAIM it supports (``stable_seq``) stays
        under this envelope signature. Detaching lets the NEW-VIEW
        assembler deduplicate the 2f+1 near-identical proofs across its
        embedded VIEW-CHANGE set (VERDICT weak #5: 237-419 KB NEW-VIEWs
        at n=64, dominated by repeated checkpoint certificates) without
        breaking any sender's signature. A relayer substituting a
        different valid proof for the same h changes nothing the
        protocol consumes; substituting an invalid one is rejected —
        the same outcome as dropping the message."""
        d = self.to_dict()
        d["sig"] = ""
        d["checkpoint_proof"] = []
        return canonical_json(d)


@dataclass
class NewView(Message):
    """NEW-VIEW: the new primary's certificate installing view v+1.

    ``checkpoint_pool`` deduplicates checkpoint certificates across the
    embedded VIEW-CHANGE set: each entry is ``{"seq": h, "proof":
    [...]}`` and every shipped VIEW-CHANGE whose ``checkpoint_proof``
    arrives empty refills from the pool entry for its ``stable_seq``
    (viewchange.validate_new_view). 2f+1 replicas proving the same h
    then cost ONE copy of the certificate instead of 2f+1."""

    KIND: ClassVar[str] = "newview"
    MAX_WIRE_BYTES: ClassVar[int] = 256 * 1024 * 1024

    new_view: int = 0
    viewchange_proof: List[Dict[str, Any]] = field(default_factory=list)
    pre_prepares: List[Dict[str, Any]] = field(default_factory=list)
    checkpoint_pool: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class StateRequest(Message):
    """Lagging replica asks a peer for the snapshot at a stable checkpoint
    (state transfer — needed when a replica learns of a stable checkpoint
    beyond what it has executed)."""

    KIND: ClassVar[str] = "staterequest"

    seq: int = 0


@dataclass
class StateResponse(Message):
    """Snapshot at a stable checkpoint. The receiver validates
    sha256(snapshot) against the 2f+1 checkpoint certificate digest, so the
    responder need not be trusted."""

    KIND: ClassVar[str] = "stateresponse"

    seq: int = 0
    snapshot: str = ""


@dataclass
class StateChunkRequest(Message):
    """Ask a peer for chunk ``index`` of the snapshot at stable
    checkpoint ``seq`` (consensus/statesync.py — the bounded, resumable
    replacement for shipping the whole snapshot in one StateResponse).
    Chunk size is the SERVER's statesync.CHUNK_BYTES; the requester
    learns the chunk count from the first reply's ``total``."""

    KIND: ClassVar[str] = "statechunkrequest"

    seq: int = 0
    index: int = 0


@dataclass
class StateChunkReply(Message):
    """One snapshot chunk: ``data`` is ``snapshot[index*C:(index+1)*C]``.
    Chunks are NOT individually trusted — the assembled snapshot must
    hash to the 2f+1-certified checkpoint digest (the same authority the
    legacy StateResponse path uses), so a byzantine server can only cost
    a re-fetch, never a forged install."""

    KIND: ClassVar[str] = "statechunkreply"

    seq: int = 0
    index: int = 0
    total: int = 0  # chunk count for this snapshot
    data: str = ""


@dataclass
class ConfigFetch(Message):
    """Client -> replica: send me the committee configuration for
    ``epoch`` (or your latest). Fired when a reply's epoch outruns the
    client's address book after a live reconfiguration."""

    KIND: ClassVar[str] = "configfetch"

    epoch: int = 0


@dataclass
class ConfigReply(Message):
    """A replica's signed committee configuration: ``config`` is the
    canonical JSON of config.config_doc() (epoch, replica_ids, pubkeys).
    A client adopts a config only when f+1 KNOWN replicas (keys it
    already holds) agree on the same config bytes for the same epoch —
    one lying replica cannot steer a client into a fake committee."""

    KIND: ClassVar[str] = "configreply"

    epoch: int = 0
    config: str = ""


@dataclass
class BlockFetch(Message):
    """Ask peers for blocks by digest — view-change certificates ship
    digest-only pre-prepares (see PrePrepare.signing_payload), so a
    replica installing a NEW-VIEW may lack the block behind a re-issued
    digest. Any replica that stored the block answers."""

    KIND: ClassVar[str] = "blockfetch"

    digests: List[str] = field(default_factory=list)


@dataclass
class BlockReply(Message):
    """Blocks for a BlockFetch: entries of {"digest": ..., "block": [...]}.
    Self-authenticating — the receiver recomputes block_digest(block) and
    drops mismatches, so the responder need not be trusted. Carries full
    request blocks, so it shares the certificate-class wire cap (and
    responders chunk replies well below it — replica._on_block_fetch)."""

    KIND: ClassVar[str] = "blockreply"
    MAX_WIRE_BYTES: ClassVar[int] = 64 * 1024 * 1024

    blocks: List[Dict[str, Any]] = field(default_factory=list)


# The digest of the empty (no-op) block: O-set gap slots and detached
# pre-prepare resolution both compare against it on hot paths.
@dataclass
class SlotFetch(Message):
    """Steady-state hole-filling: ask a peer (normally the primary) to
    re-send a stalled slot's artifacts — the pre-prepare and, in QC
    mode, the phase QuorumCerts. Execution is sequential per replica, so
    under message loss every replica eventually holds a HOLE (one
    dropped pre-prepare or QC) that blocks it forever; without this the
    only recovery paths were checkpoint state transfer or a full view
    change (measured at n=64/QC with 2%% drop: the committee stalled
    every ~14 blocks and paid a whole failover to self-heal)."""

    KIND: ClassVar[str] = "slotfetch"

    view: int = 0
    seqs: List[int] = field(default_factory=list)


@dataclass
class NewViewFetch(Message):
    """Ask a peer to re-send the NEW-VIEW certificate that installed a
    view >= ``view``. Signature-verified traffic from a higher view is
    proof such a certificate exists, but the NEW-VIEW broadcast itself
    is sent once — a replica that loses that one frame is marooned in a
    dead view until the next full failover (measured at n=64 under 2%
    drop: a committee split across views for the rest of the run). The
    reply is the original NEW-VIEW message, still carrying its primary's
    envelope signature and embedded certificates, so the requester
    validates it exactly like the broadcast (viewchange.on_new_view)."""

    KIND: ClassVar[str] = "newviewfetch"

    view: int = 0


EMPTY_BLOCK_DIGEST = PrePrepare.block_digest([])

ALL_KINDS = tuple(sorted(_REGISTRY))

# DEFERRABLE message classes: every sender here has its own retry path
# (clients back off and retransmit, fetch/probe requesters re-fire on
# their own timers), so a dropped instance costs one retransmission.
# Everything else is quorum-critical by default — an unlisted class is
# KEPT, the safe polarity for consensus liveness. This tuple is the
# SINGLE source for both consumers: replica.SHED_DEFERRABLE (overload
# shedding, pre-verify) and tcp._DEFERRABLE_KINDS (mid-write requeue /
# reconnect-drain policy) — hosted here so the transport never imports
# the consensus layer and the two sets cannot drift.
DEFERRABLE = (
    Request, SlotFetch, BlockFetch, StateRequest, NewViewFetch,
    StateChunkRequest, ConfigFetch,
)
DEFERRABLE_KINDS = frozenset(c.KIND for c in DEFERRABLE)
