"""The general generator of signed consensus traffic, from the seed.

Every key, message, value and signature of a run comes from `--seed`
and the configuration: replica i's Ed25519 key is SHA-256(seed, "r<i>"),
a client's SHA-256(seed, "c<j>"). Messages are the port's wire encoding
of each signing payload (canonical JSON: sorted keys, no spaces), as a
view-0 round of PBFT sends them for one request: the client's request,
the primary's pre-prepare, every backup's prepare and every replica's
commit (2n + 1 signed messages a request).

`inbound_sweep(i, j)` is what replica i receives for request j: the
request, the pre-prepare unless i is the primary, the prepares of the
other backups and the commits of the other replicas, 2n - 1 items.
A traffic mix of kind `flood` (traffic/<mix>.json) names how many items
a process keeps in its pool and how often one is corrupted; `flood_pool`
builds a process's pool from it, `expected` the verdicts a correct
verifier returns.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Tuple

import numpy as np

from . import signing
from .reference.ed25519 import L


def canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def key_seed(seed: int, name: str) -> bytes:
    return hashlib.sha256(f"pbft_bench/{seed}/{name}".encode()).digest()


def names(cfg: dict) -> Tuple[List[str], List[str]]:
    return ([f"r{i}" for i in range(cfg["n"])],
            [f"c{j}" for j in range(cfg["clients"])])


def pubkeys(cfg: dict, seed: int) -> Dict[str, bytes]:
    replicas, clients = names(cfg)
    return {nm: signing.expand(key_seed(seed, nm))[2] for nm in replicas + clients}


def _tag(seed: int) -> str:
    return hashlib.sha256(f"pbft_bench/{seed}/values".encode()).hexdigest()[:8]


def put_op(seed: int, client: int, slot: str, i: int) -> str:
    """The committee's and the floods' request: a KV put of the bench's
    small payload, key and value made from the seed."""
    return f"put k{client}.{slot} {_tag(seed)}{i}"


class Round:
    """The signed messages of `requests` view-0 rounds under `cfg`.

    msgs[m] is (signer name, payload bytes) and sigs[m] its signature;
    request j's messages are rows j * (2n + 1) onward: the request, the
    pre-prepare, the prepares of r1..r{n-1}, the commits of r0..r{n-1}."""

    def __init__(self, cfg: dict, seed: int, requests: int):
        n, nc = cfg["n"], cfg["clients"]
        self.n, self.requests = n, requests
        self.pub = pubkeys(cfg, seed)
        per_signer: Dict[str, List[int]] = {}
        self.msgs: List[Tuple[str, bytes]] = []

        def add(signer: str, payload: bytes) -> None:
            per_signer.setdefault(signer, []).append(len(self.msgs))
            self.msgs.append((signer, payload))

        reqs = []
        for j in range(requests):
            c = j % nc
            req = {"ack": j // nc, "client_id": f"c{c}", "kind": "request",
                   "operation": put_op(seed, c, str(j % 64), j), "sender": f"c{c}",
                   "sig": "", "timestamp": j // nc + 1}
            reqs.append(req)
        # requests are signed first: the pre-prepare's digest covers the
        # signed request, as a block does
        req_sigs = {}
        for c in range(nc):
            js = list(range(c, requests, nc))
            sigs = signing.sign_many(key_seed(seed, f"c{c}"),
                                     [canonical(reqs[j]) for j in js], b"requests")
            req_sigs.update(zip(js, sigs))
        for j, req in enumerate(reqs):
            add(req["client_id"], canonical(req))
            block = [dict(req, sig=req_sigs[j].hex())]
            digest = hashlib.sha256(canonical(block)).hexdigest()
            vote = {"digest": digest, "seq": j + 1, "sig": "", "view": 0}
            add("r0", canonical({**vote, "block": [], "kind": "preprepare",
                                 "sender": "r0"}))
            for k in range(1, n):
                add(f"r{k}", canonical({**vote, "bls_share": "", "kind": "prepare",
                                        "sender": f"r{k}"}))
            for k in range(n):
                add(f"r{k}", canonical({**vote, "bls_share": "", "kind": "commit",
                                        "sender": f"r{k}"}))
        self.sigs: List[bytes] = [b""] * len(self.msgs)
        for signer, rows in per_signer.items():
            if signer.startswith("c"):
                for m in rows:
                    self.sigs[m] = req_sigs[m // (2 * n + 1)]
                continue
            sigs = signing.sign_many(key_seed(seed, signer),
                                     [self.msgs[m][1] for m in rows], b"votes")
            for m, s in zip(rows, sigs):
                self.sigs[m] = s

    def inbound_sweep(self, i: int, j: int) -> List[int]:
        """Rows replica i receives for request j (2n - 1 of them)."""
        n, base = self.n, j * (2 * self.n + 1)
        rows = [base] + ([base + 1] if i != 0 else [])
        rows += [base + 1 + k for k in range(1, n) if k != i]
        rows += [base + n + 1 + k for k in range(n) if k != i]
        return rows


CORRUPTIONS = ("message_bit", "r_bit", "s_bit", "s_plus_l", "other_key")


def corrupt(kind: str, pub: bytes, msg: bytes, sig: bytes, other_pub: bytes,
            bit: int) -> Tuple[bytes, bytes, bytes]:
    """One corrupted (pubkey, message, signature); each kind fails RFC
    8032 verification under the program's policy (`s_plus_l` keeps the
    equation and breaks only S < L, the malleability rule)."""
    if kind == "message_bit":
        b = bytearray(msg)
        b[bit % len(b)] ^= 1 << (bit % 8)
        return pub, bytes(b), sig
    if kind == "r_bit":
        b = bytearray(sig)
        b[bit % 32] ^= 1 << (bit % 8)
        return pub, msg, bytes(b)
    if kind == "s_bit":
        s = int.from_bytes(sig[32:], "little") ^ (1 << (bit % 250))
        return pub, msg, sig[:32] + s.to_bytes(32, "little")
    if kind == "s_plus_l":
        s = int.from_bytes(sig[32:], "little") + L
        return pub, msg, sig[:32] + s.to_bytes(32, "little")
    if kind == "other_key":
        return other_pub, msg, sig
    raise ValueError(kind)


class FloodPool:
    """One process's pool: sweeps of (pubkey, msg, sig) triples and the
    verdict a correct verifier gives each item."""

    def __init__(self, sweeps, verdicts, kinds):
        self.sweeps = sweeps      # list of lists of (pub, msg, sig)
        self.verdicts = verdicts  # list of lists of bool
        self.kinds = kinds        # {(sweep, pos): corruption kind}

    @property
    def items(self) -> int:
        return sum(len(s) for s in self.sweeps)


def sweep_count(cfg: dict, traffic: dict) -> int:
    return traffic["pool_items"] // (2 * cfg["n"] - 1)


def flood_pool(rnd: Round, cfg: dict, traffic: dict, seed: int, rank: int) -> FloodPool:
    """Process `rank`'s pool. Layout `process_per_replica`: the process is
    replica `rank`, its sweep j the inbound sweep of request j. Layout
    `shared_service`: sweep j is replica (j mod n)'s inbound sweep of
    request j. Exactly one item in `corrupt_one_in` is corrupted, at
    places and in kinds drawn from the seed and the rank."""
    n = cfg["n"]
    shared = cfg["layout"] == "shared_service"
    sweeps, verdicts = [], []
    names_ = list(rnd.pub)
    for j in range(sweep_count(cfg, traffic)):
        i = j % n if shared else rank
        rows = rnd.inbound_sweep(i, j)
        sweeps.append([(rnd.pub[rnd.msgs[m][0]], rnd.msgs[m][1], rnd.sigs[m]) for m in rows])
        verdicts.append([True] * len(rows))
    flat = [(s, p) for s in range(len(sweeps)) for p in range(len(sweeps[s]))]
    rng = np.random.default_rng([seed % (1 << 63), rank, 64])
    count = len(flat) // traffic["corrupt_one_in"]
    kinds = {}
    for c, f in enumerate(rng.choice(len(flat), size=count, replace=False)):
        s, p = flat[int(f)]
        kind = CORRUPTIONS[c % len(CORRUPTIONS)]
        pub, msg, sig = sweeps[s][p]
        other = rnd.pub[names_[(names_.index(_signer(rnd, pub)) + 1) % len(names_)]]
        sweeps[s][p] = corrupt(kind, pub, msg, sig, other, int(rng.integers(1 << 30)))
        verdicts[s][p] = False
        kinds[(s, p)] = kind
    return FloodPool(sweeps, verdicts, kinds)


def _signer(rnd: Round, pub: bytes) -> str:
    for nm, pk in rnd.pub.items():
        if pk == pub:
            return nm
    raise KeyError(pub)
