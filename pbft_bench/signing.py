"""Seeded Ed25519 signing for the benchmark's traffic, in plain Python.

`sign` is RFC 8032's deterministic signature. `sign_many` signs a list
of messages under one key with nonces r0, r0 + 1, r0 + 2, ... (r0 from
the key's prefix and a seed), so each nonce point is the last one plus
B, and one batch inversion encodes them all: a few microseconds a
signature instead of a scalar multiplication each. The signatures are
valid Ed25519 signatures; only the nonce's derivation differs from the
RFC's, which a verifier never sees. Nothing of the program is used.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

from .reference.ed25519 import B, L, P, point_add, point_compress, point_mul


def expand(seed: bytes) -> Tuple[int, bytes, bytes]:
    """RFC 8032 §5.1.5: seed -> (secret scalar a, nonce prefix, public key)."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:], point_compress(point_mul(a, B))


def sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 §5.1.6."""
    a, prefix, pub = expand(seed)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    r_enc = point_compress(point_mul(r, B))
    k = int.from_bytes(hashlib.sha512(r_enc + pub + msg).digest(), "little") % L
    return r_enc + ((r + k * a) % L).to_bytes(32, "little")


def _batch_invert(zs: List[int]) -> List[int]:
    """Montgomery's trick: every z^-1 mod p for one exponentiation."""
    prefix = [1] * (len(zs) + 1)
    for i, z in enumerate(zs):
        prefix[i + 1] = prefix[i] * z % P
    inv = pow(prefix[-1], P - 2, P)
    out = [0] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        out[i] = prefix[i] * inv % P
        inv = inv * zs[i] % P
    return out


def sign_many(seed: bytes, msgs: Sequence[bytes], nonce_seed: bytes) -> List[bytes]:
    """Sign every message under `seed`'s key, nonces r0 + i."""
    a, prefix, pub = expand(seed)
    r0 = int.from_bytes(hashlib.sha512(prefix + nonce_seed).digest(), "little") % L
    pts = []
    pt = point_mul(r0, B)
    for _ in msgs:
        pts.append(pt)
        pt = point_add(pt, B)
    zinv = _batch_invert([p[2] for p in pts])
    sigs = []
    for i, (msg, p, zi) in enumerate(zip(msgs, pts, zinv)):
        x, y = p[0] * zi % P, p[1] * zi % P
        r_enc = (y | ((x & 1) << 255)).to_bytes(32, "little")
        k = int.from_bytes(hashlib.sha512(r_enc + pub + msg).digest(), "little") % L
        sigs.append(r_enc + ((r0 + i + k * a) % L).to_bytes(32, "little"))
    return sigs
