"""Pure-Python Ed25519 (RFC 8032) — signing + known-answer verification.

Written from the RFC 8032 / original Ed25519 paper math. This is the CPU
backend of the crypto plane: replicas sign with it, and it is the oracle the
JAX/TPU batched verifier is tested against. Not constant-time — fine for a
consensus *verification* oracle and test keygen; production signing keys
should live behind an HSM-style interface anyway.

The reference (the reference) has no signatures; this module plus the TPU
verifier fills the gap its author logged in 需要改进的地方.md:17.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

# ---------------------------------------------------------------------------
# Field and curve constants
# ---------------------------------------------------------------------------

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P  # edwards d
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p

# Extended homogeneous coordinates (X, Y, Z, T) with x=X/Z, y=Y/Z, T=XY/Z.
Point = Tuple[int, int, int, int]

IDENTITY: Point = (0, 1, 1, 0)


def _recover_x(y: int, sign: int) -> Optional[int]:
    """x from y per RFC 8032 §5.1.3: x^2 = (y^2-1)/(d y^2+1)."""
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        if sign:
            return None
        return 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if x & 1 != sign:
        x = P - x
    return x


# Base point: y = 4/5, x with sign bit 0.
_BY = 4 * pow(5, P - 2, P) % P
_BX = _recover_x(_BY, 0)
B: Point = (_BX, _BY, 1, _BX * _BY % P)


# ---------------------------------------------------------------------------
# Point arithmetic (extended coordinates, a=-1 twisted Edwards)
# ---------------------------------------------------------------------------


def point_add(p: Point, q: Point) -> Point:
    """Unified addition (Hisil et al. add-2008-hwcd-3)."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    Bv = (Y1 + X1) * (Y2 + X2) % P
    C = T1 * 2 * D * T2 % P
    Dv = Z1 * 2 * Z2 % P
    E = Bv - A
    F = Dv - C
    G = Dv + C
    H = Bv + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def point_double(p: Point) -> Point:
    """Doubling (dbl-2008-hwcd)."""
    X1, Y1, Z1, _ = p
    A = X1 * X1 % P
    Bv = Y1 * Y1 % P
    C = 2 * Z1 * Z1 % P
    H = A + Bv
    E = H - (X1 + Y1) * (X1 + Y1) % P
    G = A - Bv
    F = C + G
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def point_mul(s: int, p: Point) -> Point:
    q = IDENTITY
    while s > 0:
        if s & 1:
            q = point_add(q, p)
        p = point_double(p)
        s >>= 1
    return q


def point_equal(p: Point, q: Point) -> bool:
    # X1/Z1 == X2/Z2  and  Y1/Z1 == Y2/Z2
    return (
        (p[0] * q[2] - q[0] * p[2]) % P == 0
        and (p[1] * q[2] - q[1] * p[2]) % P == 0
    )


def point_compress(p: Point) -> bytes:
    zinv = pow(p[2], P - 2, P)
    x = p[0] * zinv % P
    y = p[1] * zinv % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def point_decompress(s: bytes) -> Optional[Point]:
    if len(s) != 32:
        return None
    enc = int.from_bytes(s, "little")
    sign = enc >> 255
    y = enc & ((1 << 255) - 1)
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def point_to_affine(p: Point) -> Tuple[int, int]:
    zinv = pow(p[2], P - 2, P)
    return (p[0] * zinv % P, p[1] * zinv % P)


# ---------------------------------------------------------------------------
# Keys / sign / verify  (RFC 8032 §5.1.5-5.1.7)
# ---------------------------------------------------------------------------


def _sha512(*parts: bytes) -> bytes:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return h.digest()


def _sha512_mod_l(*parts: bytes) -> int:
    return int.from_bytes(_sha512(*parts), "little") % L


def secret_expand(seed: bytes) -> Tuple[int, bytes]:
    h = _sha512(seed)
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


_PUB_CACHE: dict = {}


def public_key(seed: bytes) -> bytes:
    """Compressed public key for a seed (memoized — replicas sign every
    consensus message, and the pubkey derivation is a full scalar mult)."""
    pub = _PUB_CACHE.get(seed)
    if pub is None:
        a, _ = secret_expand(seed)
        pub = point_compress(point_mul(a, B))
        _PUB_CACHE[seed] = pub
    return pub


def sign(seed: bytes, msg: bytes) -> bytes:
    a, prefix = secret_expand(seed)
    apub = public_key(seed)
    r = int.from_bytes(_sha512(prefix, msg), "little") % L
    rpt = point_compress(point_mul(r, B))
    k = _sha512_mod_l(rpt, apub, msg)
    s = (r + k * a) % L
    return rpt + int.to_bytes(s, 32, "little")


def verify(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """Cofactorless verification: [S]B == R + [k]A (RFC 8032 permits)."""
    if len(sig) != 64 or len(pubkey) != 32:
        return False
    a_pt = point_decompress(pubkey)
    if a_pt is None:
        return False
    r_pt = point_decompress(sig[:32])
    if r_pt is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:  # non-canonical S → malleable; reject
        return False
    k = _sha512_mod_l(sig[:32], pubkey, msg)
    return point_equal(point_mul(s, B), point_add(r_pt, point_mul(k, a_pt)))


def challenge_scalar(r_enc: bytes, pubkey: bytes, msg: bytes) -> int:
    """k = SHA-512(R || A || M) mod L — exposed for the TPU backend, which
    takes precomputed challenge scalars when host-side hashing is used."""
    return _sha512_mod_l(r_enc, pubkey, msg)


def batch_verify_cpu(
    pubkeys: List[bytes], msgs: List[bytes], sigs: List[bytes]
) -> List[bool]:
    """Independent per-item verification (the semantics the consensus plane
    needs: a bitmap, not an all-or-nothing batch equation)."""
    return [verify(p, m, s) for p, m, s in zip(pubkeys, msgs, sigs)]
