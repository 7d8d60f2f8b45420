"""GF(2^255 - 19) arithmetic in int32 limbs, as PyTorch tensor code.

The representation is the JAX package's, limb for limb: 17 limbs of 15
bits held in int32 (17 * 15 = 255 exactly), so that

- a limb product fits int32: (2^15 + eps)^2 < 2^31;
- the schoolbook convolution never overflows: each 30-bit product is split
  into (lo = p & 0x7fff, hi = p >> 15) before accumulation, so a column
  sums at most 17 lo-terms (< 2^15) + 17 hi-terms (< 2^16) < 2^21;
- the reduction fold is a clean multiply-by-19: limb position 17 has
  weight 2^255 ≡ 19 (mod p), so high columns fold back as `col * 19`.

Layout: a field element is an int32 tensor `(17, ...)` — the LIMB axis
leads and batch axes trail, so a (17, B) element's rows are contiguous
batch vectors and every op below is one elementwise pass over them.

Every function is shape-polymorphic over TRAILING batch dimensions and
runs on whatever device its inputs lie on. No op widens to int64: the
reductions pass ``dtype=torch.int32`` and all constants are int32.

Normal form ("weak"): limbs 1..16 in [0, 2^15); limb 0 in [0, 2^15 + 19].
`to_canonical` produces the unique representative < p for comparisons and
encoding.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

NLIMB = 17
RADIX = 15
MASK = (1 << RADIX) - 1  # 0x7fff
P_INT = 2**255 - 19

DTYPE = torch.int32


def _int_to_limbs_np(v: int) -> np.ndarray:
    """Host-side: Python int -> (17,) int32 limb array."""
    out = np.zeros(NLIMB, dtype=np.int32)
    for i in range(NLIMB):
        out[i] = v & MASK
        v >>= RADIX
    if v:
        raise ValueError("value exceeds 255 bits")
    return out


def _limbs_to_int_np(limbs: np.ndarray) -> int:
    """Host-side inverse (for tests/debug); limb axis leading."""
    v = 0
    for i in reversed(range(NLIMB)):
        # .item(): exact for scalars AND size-1 batch dims, and loudly
        # fails on a real batch instead of silently folding it
        v = (v << RADIX) | int(np.asarray(limbs[i, ...]).item())
    return v


ZERO = _int_to_limbs_np(0)
ONE = _int_to_limbs_np(1)
P_LIMBS = _int_to_limbs_np(P_INT)
# 2p as limbs: only limb 0 differs from 2*MASK
TWO_P_LIMBS = np.array([2 * (2**RADIX - 19)] + [2 * MASK] * (NLIMB - 1), np.int32)


@functools.lru_cache(maxsize=None)
def _limb_const(name: str, device: torch.device) -> torch.Tensor:
    """A (17,) int32 limb constant on `device`, uploaded once per device
    (a fresh host->device copy per field op would stall the stream)."""
    table = {"p": P_LIMBS, "two_p": TWO_P_LIMBS, "zero": ZERO, "one": ONE}
    return torch.as_tensor(table[name], dtype=DTYPE, device=device)


def bcast(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reshape a (17,) limb constant so it broadcasts against x's
    trailing batch axes: (17,) -> (17, 1, ..., 1)."""
    return c.reshape((NLIMB,) + (1,) * (x.dim() - 1))


# ---------------------------------------------------------------------------
# Carry propagation / normalization
# ---------------------------------------------------------------------------


def _ripple(x: torch.Tensor) -> torch.Tensor:
    """One sequential carry pass: limbs -> [0, 2^15), carry-out folded in
    as *19 on limb 0 (2^255 ≡ 19 mod p). Exact but latency-bound (17
    dependent steps) — used only by `normalize_strict` / `to_canonical`."""
    outs: List[torch.Tensor] = []
    c = torch.zeros_like(x[0])
    for i in range(NLIMB):
        t = x[i] + c
        outs.append(t & MASK)
        c = t >> RADIX
    outs[0] = outs[0] + 19 * c
    return torch.stack(outs, dim=0)


def normalize_strict(x: torch.Tensor) -> torch.Tensor:
    """Two sequential carry passes -> strict weak form (limbs 1..16 in
    [0, 2^15), limb0 < 2^15 + 19). Needed before to_canonical's
    borrow-ripple subtraction, which assumes in-range limbs."""
    return _ripple(_ripple(x))


def _carry_pass(x: torch.Tensor) -> torch.Tensor:
    """One PARALLEL carry pass over the whole limb axis: every limb sheds
    its carry to its neighbor simultaneously; the top carry folds into
    limb 0 as *19."""
    c = x >> RADIX
    shifted = torch.cat([19 * c[-1:], c[:-1]], dim=0)
    return (x & MASK) + shifted


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Two parallel carry passes -> relaxed weak form. Hot-path invariant
    (inputs nonnegative, limbs < 2^26 — the mul-fold bound):

    - pass 1: carries < 2^11, so limbs < 2^15 + 2^11 (limb 0 gets 19*c
      < 2^16.3, still < 2^17);
    - pass 2: carries <= 2 (limb 1 gets <= 2^2), so limbs land in
      [0, 2^15 + 2^11) with limb 0 < 2^15 + 19*2.

    Relaxed-weak inputs keep the next mul exact in int32:
    (2^15 + 2^11)^2 < 1.14 * 2^30 < 2^31, and the lo/hi column sums stay
    17*(2^15 + 1.14*2^16) < 2^21.
    """
    return _carry_pass(_carry_pass(x))


def to_canonical(x: torch.Tensor) -> torch.Tensor:
    """Weak form -> unique representative in [0, p).

    The borrow test `(t >> 31) & 1` relies on `>>` being ARITHMETIC on a
    negative int32, which it is for torch int32 tensors (tested)."""
    x = normalize_strict(x)
    # weak value < 2^255 + 18 < 2p, so at most one subtraction of p needed —
    # but limb0 may hold up to 2^15+18 (value can slightly exceed 2^255-1),
    # subtract with borrow and select.
    p_limbs = P_LIMBS.tolist()
    for _ in range(2):
        diff = []
        b = torch.zeros_like(x[0])
        for i in range(NLIMB):
            t = x[i] - p_limbs[i] - b
            b = (t >> 31) & 1  # 1 if negative
            diff.append(t + (b << RADIX))
        diff_arr = torch.stack(diff, dim=0)
        ge_p = (b == 0)[None]
        x = torch.where(ge_p, diff_arr, x)
    return x


# ---------------------------------------------------------------------------
# Ring ops
# ---------------------------------------------------------------------------


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum < 2^16 + 2^12 per limb, so ONE parallel carry pass suffices
    (carries <= 2) to return to relaxed weak form."""
    return _carry_pass(a + b)


def _two_p(x: torch.Tensor) -> torch.Tensor:
    """2p as limbs, shaped to broadcast against x."""
    return bcast(_limb_const("two_p", x.device), x)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b, computed as a + 2p - b to stay nonnegative (< 2^17 per
    limb, one carry pass)."""
    return _carry_pass(a + _two_p(a) - b)


def neg(a: torch.Tensor) -> torch.Tensor:
    return _carry_pass(_two_p(a) - a)


def mul_padacc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiply via 17 shifted broadcast rows (pad-accumulate).

    Each of the 17 partial rows is a broadcast multiply a_i * b ->
    (17, ...), split into lo/hi, and added into its column offset of a
    (35, ...) accumulator (slicing into the zero accumulator takes the
    place of the JAX version's pads)."""
    acc = torch.zeros((2 * NLIMB + 1,) + a.shape[1:], dtype=a.dtype, device=a.device)
    for i in range(NLIMB):
        p = a[i : i + 1] * b  # (17, ...)
        acc[i : i + NLIMB] += p & MASK
        acc[i + 1 : i + NLIMB + 1] += p >> RADIX
    # fold: column 17+t has weight 2^255 * 2^(15t) ≡ 19 * 2^(15t);
    # column 34 (top hi) is always zero since hi of a_16*b_16 lands at 33
    out = acc[:NLIMB] + 19 * acc[NLIMB : 2 * NLIMB]
    return normalize(out)


def mul_skew(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiply via the materialized outer product + skew reduction.

    Materializes a (17, 17, ...) product tensor; the antidiagonal sums use
    the skew trick (pad rows to 35 and reshape, so element (i, j) lands in
    column i + j). The column sums are exactly mul_padacc's, so the two
    give limb-identical results."""
    prod = a[:, None] * b[None, :]  # (17, 17, ...)
    rest = prod.shape[2:]

    def anti(m):
        pad = torch.zeros((NLIMB, NLIMB + 1) + rest, dtype=m.dtype, device=m.device)
        flat = torch.cat([m, pad], dim=1).reshape((NLIMB * (2 * NLIMB + 1),) + rest)
        skewed = flat[: NLIMB * 2 * NLIMB].reshape((NLIMB, 2 * NLIMB) + rest)
        return skewed.sum(dim=0, dtype=DTYPE)  # (34, ...)

    lo_cols = anti(prod & MASK)
    hi_cols = anti(prod >> RADIX)
    cols = lo_cols.clone()
    cols[1:] += hi_cols[:-1]
    out = cols[:NLIMB] + 19 * cols[NLIMB:]
    return normalize(out)


# The production field multiply. Eager PyTorch pays one launch per op, and
# the skew form is ~15 ops against ~90 for pad-accumulate; both give the
# same limbs (same column sums), so the choice moves time only.
mul = mul_skew

# The exponentiation chains' multiply.
_chain_mul = mul_skew


def sq(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small positive scalar (k < 2^15)."""
    return normalize(a * k)


# ---------------------------------------------------------------------------
# Exponentiation chains (ref10-style addition chains — 254 squarings,
# ~12 multiplies; vs ~510 multiplies for binary square-and-multiply)
# ---------------------------------------------------------------------------


def _sqn(x: torch.Tensor, n: int) -> torch.Tensor:
    """x^(2^n) via n squarings."""
    for _ in range(n):
        x = _chain_mul(x, x)
    return x


def _chain_250(x: torch.Tensor):
    """Shared prefix: returns (x^(2^250 - 1), x^11, x^2)."""
    z2 = _chain_mul(x, x)
    z8 = _sqn(z2, 2)
    z9 = _chain_mul(x, z8)
    z11 = _chain_mul(z2, z9)
    z22 = _chain_mul(z11, z11)
    z_5_0 = _chain_mul(z9, z22)  # x^(2^5 - 1)
    z_10_5 = _sqn(z_5_0, 5)
    z_10_0 = _chain_mul(z_10_5, z_5_0)  # x^(2^10 - 1)
    z_20_10 = _sqn(z_10_0, 10)
    z_20_0 = _chain_mul(z_20_10, z_10_0)
    z_40_20 = _sqn(z_20_0, 20)
    z_40_0 = _chain_mul(z_40_20, z_20_0)
    z_50_10 = _sqn(z_40_0, 10)
    z_50_0 = _chain_mul(z_50_10, z_10_0)
    z_100_50 = _sqn(z_50_0, 50)
    z_100_0 = _chain_mul(z_100_50, z_50_0)
    z_200_100 = _sqn(z_100_0, 100)
    z_200_0 = _chain_mul(z_200_100, z_100_0)
    z_250_50 = _sqn(z_200_0, 50)
    z_250_0 = _chain_mul(z_250_50, z_50_0)  # x^(2^250 - 1)
    return z_250_0, z11, z2


def invert(x: torch.Tensor) -> torch.Tensor:
    """x^(p-2) = x^(2^255 - 21): multiplicative inverse (0 -> 0)."""
    z_250_0, z11, _ = _chain_250(x)
    return _chain_mul(_sqn(z_250_0, 5), z11)


def pow22523(x: torch.Tensor) -> torch.Tensor:
    """x^((p-5)/8) = x^(2^252 - 3) — the square-root helper exponent."""
    z_250_0, _, _ = _chain_250(x)
    return _chain_mul(_sqn(z_250_0, 2), x)


# ---------------------------------------------------------------------------
# Predicates / conversion helpers
# ---------------------------------------------------------------------------


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical equality -> bool (...,)."""
    return torch.all(to_canonical(a) == to_canonical(b), dim=0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(to_canonical(a) == 0, dim=0)


def parity(a: torch.Tensor) -> torch.Tensor:
    """Low bit of the canonical representative (the Edwards sign bit)."""
    return to_canonical(a)[0] & 1


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b, broadcasting cond (...,) over the leading limb axis."""
    return torch.where(cond[None], a, b)


# ---------------------------------------------------------------------------
# Host-side byte <-> limb conversion (vectorized numpy; used by the
# verifier's batch-preparation path). Host arrays are batch-major (n, 17)
# — natural for row-wise wire decoding — and transposed to the device's
# limb-major layout at staging time.
# ---------------------------------------------------------------------------


def extract_windows_np(data: np.ndarray, wbits: int, count: int) -> np.ndarray:
    """(n, 32) uint8 little-endian -> (count, n) int32: window i holds
    bits [i*wbits, (i+1)*wbits) of the 256-bit value, position-major (the
    device layout, produced directly so hot prep paths never transpose).

    View the bytes as four little-endian uint64 words and extract each
    window with two shifts — `count` vectorized ops total vs an
    unpackbits expansion to 256 int32 lanes per item. Windows extending
    past bit 255 are naturally truncated. Shared by the field-limb
    (wbits=15) and comb-window (wbits=4/5/6) decoders so the word-straddle
    logic lives in exactly one place."""
    words = np.ascontiguousarray(data).view("<u8")  # (n, 4)
    mask = np.uint64((1 << wbits) - 1)
    out = np.empty((count, data.shape[0]), dtype=np.int32)
    for i in range(count):
        bitpos = i * wbits
        w, s = bitpos >> 6, bitpos & 63
        v = words[:, w] >> np.uint64(s)
        if s > 64 - wbits and w + 1 < 4:  # window straddles a word boundary
            v = v | (words[:, w + 1] << np.uint64(64 - s))
        out[i] = (v & mask).astype(np.int32)
    return out


def bytes32_to_limbs_major_np(data: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 little-endian -> (17, n) int32 limbs of the low 255
    bits (bit 255 — the sign bit — is excluded), limb-major."""
    return extract_windows_np(data, RADIX, NLIMB)


@functools.lru_cache(maxsize=None)
def _window_plan(wbits: int, count: int, device: torch.device):
    """Static byte-gather plan of extract_windows_dev, uploaded once per
    (wbits, count, device): for each of the (at most) three bytes a
    window spans, the byte column, whether it exists, and the shifts."""
    bitpos = np.arange(count) * wbits
    lo = bitpos >> 3
    sh = bitpos & 7
    plan = []
    for k in range(3):  # wbits<=15 and sh<=7 => a window spans <=3 bytes
        idx = np.minimum(lo + k, 31)
        valid = lo + k <= 31
        left = np.maximum(8 * k - sh, 0)  # k=0 only ever shifts right
        right = np.maximum(sh - 8 * k, 0)
        plan.append(tuple(
            torch.as_tensor(a, device=device)
            for a in (idx.astype(np.int64), valid, left.astype(np.int32),
                      right.astype(np.int32))
        ))
    return plan


def extract_windows_dev(data: torch.Tensor, wbits: int, count: int) -> torch.Tensor:
    """Device-side twin of extract_windows_np: (n, 32) uint8 wire bytes ->
    (count, n) int32 windows. Each window gathers its (at most) three
    covering bytes and shifts in int32 — static column indexing only."""
    b = data.to(DTYPE)  # (n, 32)
    v = None
    for idx, valid, left, right in _window_plan(wbits, count, data.device):
        byte = torch.where(valid, b[:, idx], 0)  # (n, count)
        part = (byte << left) >> right
        v = part if v is None else v | part
    return (v & ((1 << wbits) - 1)).T.contiguous()


def bytes32_to_limbs_np(data: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 little-endian -> (n, 17) int32 limbs (batch-major
    form for host-side table building; see bytes32_to_limbs_major_np)."""
    return bytes32_to_limbs_major_np(data).T


def sign_bits_np(data: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 -> (n,) int32 top bit (Edwards x sign)."""
    return (data[..., 31] >> 7).astype(np.int32)
