"""Edwards25519 point arithmetic in extended coordinates (a = -1), PyTorch.

Points are int32 tensors (4, 17, ...): stacked (X, Y, Z, T) limb vectors
with x = X/Z, y = Y/Z, T = XY/Z, limb axis leading and batch axes
trailing, as in ops/field25519.py.

The JAX package's ``ops/edwards.py``, function for function and limb for
limb: `point_add` (the accumulate kernel's combine step), and the ladder
mode's `point_double`, `point_neg`, `point_select`, the Straus ladder
`double_scalar_mul_base`, `compress` and `decompress`. These are the plain
versions of the ladder kernel (csrc/ladder_verify.cu), which uses the same
formulas: unified add-2008-hwcd-3 and dbl-2008-hwcd, as the CPU oracle in
crypto/ed25519_cpu.py does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import field25519 as fe
from ..crypto import ed25519_cpu as ref

D2_INT = (2 * ref.D) % ref.P
SQRT_M1 = fe._int_to_limbs_np(ref.SQRT_M1)
D_LIMBS = fe._int_to_limbs_np(ref.D)
D2_LIMBS = fe._int_to_limbs_np(D2_INT)


def _point_const(p) -> np.ndarray:
    return np.stack([fe._int_to_limbs_np(c % ref.P) for c in p])


IDENTITY = _point_const(ref.IDENTITY)  # (4, 17)
BASE = _point_const(ref.B)

_CONSTS = {"d": D_LIMBS, "d2": D2_LIMBS, "sqrt_m1": SQRT_M1, "identity": IDENTITY,
           "base": BASE}


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device) -> torch.Tensor:
    """A limb constant ((17,) or a (4, 17) point), uploaded once per device."""
    return torch.as_tensor(_CONSTS[name], dtype=fe.DTYPE, device=device)


def _pconst(name: str, like: torch.Tensor) -> torch.Tensor:
    """(4, 17) point constant -> broadcastable against (4, 17, ...)."""
    return _const(name, like.device).reshape((4, fe.NLIMB) + (1,) * (like.dim() - 2))


def point_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Unified addition (add-2008-hwcd-3, complete on Ed25519); mirrors
    ed25519_cpu.point_add."""
    x1, y1, z1, t1 = p[0], p[1], p[2], p[3]
    x2, y2, z2, t2 = q[0], q[1], q[2], q[3]
    a = fe.mul(fe.sub(y1, x1), fe.sub(y2, x2))
    b = fe.mul(fe.add(y1, x1), fe.add(y2, x2))
    c = fe.mul(fe.mul(t1, fe.bcast(_const("d2", t1.device), t1)), t2)
    d = fe.mul_small(fe.mul(z1, z2), 2)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return torch.stack([fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h)], dim=0)


def point_double(p: torch.Tensor) -> torch.Tensor:
    """Doubling (dbl-2008-hwcd); mirrors ed25519_cpu.point_double."""
    x1, y1, z1 = p[0], p[1], p[2]
    a = fe.sq(x1)
    b = fe.sq(y1)
    c = fe.mul_small(fe.sq(z1), 2)
    h = fe.add(a, b)
    e = fe.sub(h, fe.sq(fe.add(x1, y1)))
    g = fe.sub(a, b)
    f = fe.add(c, g)
    return torch.stack([fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h)], dim=0)


def point_neg(p: torch.Tensor) -> torch.Tensor:
    """-(x, y) = (-x, y); T = xy negates too."""
    return torch.stack([fe.neg(p[0]), p[1], p[2], fe.neg(p[3])], dim=0)


def point_select(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[idx] with constant shape: table (k, 4, 17, ...), idx (...,).
    A where-chain, as the JAX function: an idx outside 1..k-1 gives
    table[0]."""
    out = table[0]
    for i in range(1, table.shape[0]):
        out = torch.where((idx == i)[None, None], table[i], out)
    return out


def double_scalar_mul_base(
    s_bits: torch.Tensor, k_bits: torch.Tensor, q: torch.Tensor
) -> torch.Tensor:
    """[s]B + [k]Q via the interleaved Straus ladder.

    s_bits, k_bits: (256, ...) int32 bits, MSB first. q: (4, 17, ...).
    One shared doubling per bit; the per-bit addend is selected from the
    4-entry table {identity, B, Q, B+Q} by idx = s_bit + 2 k_bit. 256
    uniform steps, the JAX function's loop written out."""
    base = torch.broadcast_to(_pconst("base", q), q.shape)
    ident = torch.broadcast_to(_pconst("identity", q), q.shape)
    table = torch.stack([ident, base, q, point_add(base, q)], dim=0)
    acc = ident
    for i in range(256):
        acc = point_double(acc)
        acc = point_add(acc, point_select(s_bits[i] + 2 * k_bits[i], table))
    return acc


def compress(p: torch.Tensor):
    """-> (y_limbs canonical (17, ...), x_parity (...,)): the wire form is
    y with the sign bit of x in bit 255 (RFC 8032 §5.1.2)."""
    zinv = fe.invert(p[2])
    xa = fe.mul(p[0], zinv)
    ya = fe.mul(p[1], zinv)
    return fe.to_canonical(ya), fe.parity(xa)


def decompress(y_limbs: torch.Tensor, sign: torch.Tensor):
    """Recover the (4, 17, ...) extended point from y's limbs and x's sign.

    RFC 8032 §5.1.3: x^2 = (y^2-1)/(d y^2+1); the square root and the
    inversion share one exponentiation: x = u v^3 (u v^7)^((p-5)/8).
    Returns (point, ok) with ok False when x^2 is a non-residue or when
    x = 0 with sign = 1. Mirrors ed25519_cpu._recover_x (callers must
    ensure y < p: the host's canonicality check)."""
    one = fe.bcast(fe._limb_const("one", y_limbs.device), y_limbs)
    yy = fe.sq(y_limbs)
    u = fe.sub(yy, one)  # y^2 - 1
    v = fe.add(fe.mul(yy, fe.bcast(_const("d", yy.device), yy)), one)
    v3 = fe.mul(fe.sq(v), v)
    v7 = fe.mul(fe.sq(v3), v)
    x = fe.mul(fe.mul(u, v3), fe.pow22523(fe.mul(u, v7)))
    vxx = fe.mul(v, fe.sq(x))
    ok_direct = fe.eq(vxx, u)
    ok_twist = fe.eq(vxx, fe.neg(u))
    x = fe.select(ok_twist, fe.mul(x, fe.bcast(_const("sqrt_m1", x.device), x)), x)
    ok = ok_direct | ok_twist
    x = fe.to_canonical(x)
    ok = ok & ~(fe.is_zero(x) & (sign == 1))
    # match the requested sign
    flip = (x[0] & 1) != sign
    x = fe.select(flip, fe.neg(x), x)
    t = fe.mul(x, y_limbs)
    z = torch.broadcast_to(one, y_limbs.shape)
    return torch.stack([x, y_limbs, z, t], dim=0), ok
