"""Ed25519 verification as RFC 8032 writes it, in plain Python.

A frozen copy of the RFC's arithmetic (§5.1: the curve, point addition
and doubling in extended coordinates, decoding, §5.1.7 verification),
kept under the benchmark so that a change to the program cannot move
the yardstick. It imports nothing of the program.

The program's acceptance policy, written beside the RFC's check:

- S must be canonical, S < L (a signature with S + L is malleable and
  is refused, though [S]B is unchanged);
- R must decode canonically: its y below p, and x = 0 never with the
  sign bit set (a non-canonical R never matches an encoded point);
- the check is the cofactorless one, [S]B == R + [k]A, which RFC 8032
  permits.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

Point = Tuple[int, int, int, int]  # extended (X, Y, Z, T), x = X/Z, y = Y/Z
IDENTITY: Point = (0, 1, 1, 0)


def recover_x(y: int, sign: int) -> Optional[int]:
    """RFC 8032 §5.1.3: x from y and the sign bit, or None."""
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P:
        return None
    if x & 1 != sign:
        x = P - x
    return x


_BY = 4 * pow(5, P - 2, P) % P
_BX = recover_x(_BY, 0)
B: Point = (_BX, _BY, 1, _BX * _BY % P)


def point_add(p: Point, q: Point) -> Point:
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    a = (Y1 - X1) * (Y2 - X2) % P
    b = (Y1 + X1) * (Y2 + X2) % P
    c = T1 * 2 * D * T2 % P
    d = Z1 * 2 * Z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_mul(s: int, p: Point) -> Point:
    q = IDENTITY
    while s > 0:
        if s & 1:
            q = point_add(q, p)
        p = point_add(p, p)
        s >>= 1
    return q


def point_equal(p: Point, q: Point) -> bool:
    return ((p[0] * q[2] - q[0] * p[2]) % P == 0
            and (p[1] * q[2] - q[1] * p[2]) % P == 0)


def point_compress(p: Point) -> bytes:
    zinv = pow(p[2], P - 2, P)
    x, y = p[0] * zinv % P, p[1] * zinv % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def point_decompress(s: bytes) -> Optional[Point]:
    if len(s) != 32:
        return None
    enc = int.from_bytes(s, "little")
    y = enc & ((1 << 255) - 1)
    x = recover_x(y, enc >> 255)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def verify(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """RFC 8032 §5.1.7 under the program's policy (module docstring)."""
    if len(sig) != 64 or len(pubkey) != 32:
        return False
    a_pt = point_decompress(pubkey)
    r_pt = point_decompress(sig[:32])
    if a_pt is None or r_pt is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = int.from_bytes(hashlib.sha512(sig[:32] + pubkey + msg).digest(), "little") % L
    return point_equal(point_mul(s, B), point_add(r_pt, point_mul(k, a_pt)))
