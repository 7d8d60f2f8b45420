"""Fused comb-table Ed25519 verification engine, PyTorch + CUDA.

The algorithm is the JAX package's fused comb path, unchanged:

- **Pubkeys are a small committee set**, reused across every vote. The
  host decompresses each pubkey once (exact bigint math, or the native
  C++ builder) and uploads a per-key *fused table*:
  row[i*W² + ws*W + wk] = (ws·16^i) B + (wk·16^i) (−A), affine Niels form
  (y+x, y−x, 2dxy), for window positions i in 0..63 and nibbles ws, wk.
  [S]B + [k](−A) is then 64 table rows and 64 mixed adds — no doublings.
- **R never needs decompressing**: P = [S]B + [k](−A) is normalized to
  affine, and its canonical encoding (y limbs + x parity) is compared
  with R's wire bytes. A non-canonical or off-curve R simply never
  matches. The JAX package inverts the Z coordinates with one
  tree-structured batch inversion (`batch_invert`, kept here as its
  counterpart); the port's device pass inverts per lane.

Tables are rows of one of two layouts (`use_row_packing`): dense, one
(64,) int32 row per Niels entry = [y+x limbs | y−x limbs | 2dxy limbs | 13
pad], 256 bytes; or packed, two 15-bit limbs per int32, a (32,) row of 128
bytes. Compute tensors are limb-major / batch-minor ((17, B), see
field25519.py).

Windows are 4, 5 or 6 bits wide (64, 52 or 43 positions). The comb mode
(`comb_verify_kernel`) keeps a 4-bit table of A alone and a constant one
of B, and adds two rows a position, the key's row negated.

On CUDA tensors a device pass (`fused_verify_wire_kernel`,
`comb_verify_kernel`) is two hand-written kernels, built from ``csrc/`` at
first use:

- ``fused_accumulate.cu`` (K1): from the raw wire bytes, the window
  extraction, row indices, row gather and the mixed adds, a lane's
  positions split over up to 16 threads whose partial sums combine in a
  fixed tree; in comb mode the same loop over the two tables;
- ``encode_verdict.cu``: per lane, Z's inverse, affine x and y, and the
  comparison with R's encoding (R's wire bytes, or in comb mode R's
  staged limbs and sign).

The ladder mode's kernel (K9) is bound in ``ops/ladder.py`` beside its
plain version, on the `_CudaKernel` base defined here.

Both compute in radix 2^25.5 (``csrc/field25519.cuh``, points in
``csrc/edwards25519.cuh``) and read and write the 17×15 limbs of
``field25519.py`` at their edges. On CPU tensors the same functions run
their plain versions (`madd_loop_plain`, `comb_accumulate_plain`,
`wire_index_plain`, `encode_and_compare_plain`): the same formulas in
the same order, so their results equal the kernels' after canonical
reduction.

Everything stays constant-shape: npos window positions whatever the scalar,
identity entries for zero nibbles, verdicts masked by host prechecks.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np
import torch

from . import edwards
from . import field25519 as fe
from ..crypto import ed25519_cpu as ref

NPOS = 64  # 4-bit comb positions covering 256-bit scalars
WINDOW = 16
FWINDOW = WINDOW * WINDOW  # fused (s_nibble, k_nibble) window: 256 entries
ROW_DENSE = 64  # Niels row: 3*17 int32 limbs + 13 pad to a 256B row
ROW_PACKED = 32  # two 15-bit limbs per int32: 3*9 words + 5 pad, 128B
ROW = ROW_DENSE  # active row width — module global, see use_row_packing
PACKED = False
PACKED_WORDS = 9  # words of one packed element: 8 limb pairs + the 17th limb


def use_row_packing(on: bool) -> None:
    """Select the table-row layout BEFORE any table is built. Packed rows
    halve the madd loop's row bytes for two shift/mask ops per element at
    unpack. Layouts cannot mix: a bank reads ROW when it is built and a
    kernel when it launches, and a table of the other width raises there;
    that is why this is a process-wide switch and not a per-call flag."""
    global ROW, PACKED
    PACKED = bool(on)
    ROW = ROW_PACKED if on else ROW_DENSE


def npos_for(wbits: int) -> int:
    """Positions covering a 256-bit scalar with wbits-bit windows."""
    return -(-256 // wbits)


def wbits_for(npos: int) -> int:
    """The window width whose positions number npos (0 if none)."""
    return {npos_for(w): w for w in (4, 5, 6)}.get(npos, 0)


def config_name(mode: str, wbits: int, row: int) -> str:
    """A configuration of the accumulate kernel, e.g. "fused_w5_packed"."""
    return f"{mode}_w{wbits}_{'packed' if row == ROW_PACKED else 'dense'}"


# ---------------------------------------------------------------------------
# Host-side table construction (exact Python bigints -> limb rows)
# ---------------------------------------------------------------------------


def _pack_rows_np(vals: np.ndarray) -> np.ndarray:
    """(n, 3, 17) int32 Niels limbs -> (n, ROW) rows.

    Dense mode (ROW=64): one int32 per limb, 13 pad words — a 256-byte
    row of which only 204 bytes are payload. Packed mode (ROW=32, see
    `use_row_packing`): limbs are 15-bit nonnegative values, so pairs
    share an int32 (lo | hi << 15) — 9 words per element (the 17th limb
    rides alone), 27 + 5 pad = a 128-byte row."""
    n = vals.shape[0]
    out = np.zeros((n, ROW), dtype=np.int32)
    if PACKED:
        v = vals.reshape(n, 3, fe.NLIMB)
        packed = np.zeros((n, 3, PACKED_WORDS), dtype=np.int32)
        packed[:, :, :8] = v[:, :, 0:16:2] | (v[:, :, 1:16:2] << 15)
        packed[:, :, 8] = v[:, :, 16]
        out[:, : 3 * PACKED_WORDS] = packed.reshape(n, 3 * PACKED_WORDS)
    else:
        out[:, : 3 * fe.NLIMB] = vals.reshape(n, 3 * fe.NLIMB)
    return out


def _batch_affine_niels_np(points) -> np.ndarray:
    """Extended bigint points -> (n, ROW) Niels rows, with ONE
    modular inversion for the whole list (host Montgomery batch trick) and
    vectorized int->limb conversion."""
    n = len(points)
    zs = [p[2] for p in points]
    prefix = [1] * (n + 1)
    for i, z in enumerate(zs):
        prefix[i + 1] = prefix[i] * z % ref.P
    inv_all = pow(prefix[n], ref.P - 2, ref.P)
    zinv = [0] * n
    for i in range(n - 1, -1, -1):
        zinv[i] = prefix[i] * inv_all % ref.P
        inv_all = inv_all * zs[i] % ref.P
    vals = np.zeros((n, 3, 32), dtype=np.uint8)
    for i, (p, zi) in enumerate(zip(points, zinv)):
        x = p[0] * zi % ref.P
        y = p[1] * zi % ref.P
        vals[i, 0] = np.frombuffer(((y + x) % ref.P).to_bytes(32, "little"), np.uint8)
        vals[i, 1] = np.frombuffer(((y - x) % ref.P).to_bytes(32, "little"), np.uint8)
        vals[i, 2] = np.frombuffer(
            (2 * ref.D * x * y % ref.P).to_bytes(32, "little"), np.uint8
        )
    limbs = fe.bytes32_to_limbs_np(vals.reshape(n * 3, 32)).reshape(n, 3, fe.NLIMB)
    return _pack_rows_np(limbs)


def comb_table_np(point: ref.Point) -> np.ndarray:
    """(NPOS * WINDOW, ROW) rows: row[i*W + w] = (w * 16^i) * point."""
    pts = []
    base = point
    for i in range(NPOS):
        acc = ref.IDENTITY
        for w in range(WINDOW):
            pts.append(acc)
            acc = ref.point_add(acc, base)
        for _ in range(4):  # base <- 16 * base
            base = ref.point_double(base)
    return _batch_affine_niels_np(pts)


def _point_neg(p: ref.Point) -> ref.Point:
    x, y, z, t = p
    return ((-x) % ref.P, y, z, (-t) % ref.P)


def fused_table_np(point: ref.Point, wbits: int = 4) -> np.ndarray:
    """(npos * 4^wbits, ROW) rows for wbits-bit windows:
    row[i*FW + ws*2^w + wk] = (ws * 2^(w*i)) B + (wk * 2^(w*i)) (−A),
    FW = 4^wbits, npos = ceil(256/wbits).

    One row fetch + ONE mixed add per window position evaluates
    [S]B + [k](−A). Wider windows cut positions (and madds) at the cost
    of a bigger per-key table: in dense rows w=4 -> 64 positions / 4 MiB
    per key, w=5 -> 52 / 13 MiB, w=6 -> 43 / 43 MiB (packed rows halve
    each). KeyBank caps how many keys live on the device.
    """
    # Native fast path (native/ed25519.cpp): the same build in C++ group
    # arithmetic. Output is affine-Niels field-element BYTES; the
    # vectorized bytes->limb conversion below is shared with the Python
    # path, so both produce bit-identical rows.
    from .. import native

    x, y = ref.point_to_affine(point)
    a_xy = np.frombuffer(
        x.to_bytes(32, "little") + y.to_bytes(32, "little"), dtype=np.uint8
    )
    nb = native.ed25519_fused_table(a_xy, wbits)
    if nb is not None:
        n = nb.shape[0]
        limbs = fe.bytes32_to_limbs_np(
            nb.reshape(n * 3, 32)
        ).reshape(n, 3, fe.NLIMB)
        return _pack_rows_np(limbs)

    window = 1 << wbits
    pts = []
    base_b = ref.B
    base_a = _point_neg(point)
    for i in range(npos_for(wbits)):
        row_b = ref.IDENTITY
        for ws in range(window):
            acc = row_b
            for wk in range(window):
                pts.append(acc)
                acc = ref.point_add(acc, base_a)
            row_b = ref.point_add(row_b, base_b)
        for _ in range(wbits):  # bases <- 2^wbits * bases
            base_b = ref.point_double(base_b)
            base_a = ref.point_double(base_a)
    return _batch_affine_niels_np(pts)


_BASE_TABLES = {}  # ROW -> the base point's comb table in that layout
_BASE_TABLES_DEV = {}  # (ROW, device) -> its device copy


def base_table() -> np.ndarray:
    """Constant comb table of the Ed25519 base point in the active layout
    (built once per layout)."""
    if ROW not in _BASE_TABLES:
        _BASE_TABLES[ROW] = comb_table_np(ref.B)
    return _BASE_TABLES[ROW]


def base_table_device(device="cuda") -> torch.Tensor:
    """Device-resident copy of base_table() (uploaded once per layout and
    device — the verify hot path must not re-transfer it per batch)."""
    device = torch.device(device)
    key = (ROW, device)
    if key not in _BASE_TABLES_DEV:
        _BASE_TABLES_DEV[key] = torch.from_numpy(base_table()).to(device)
    return _BASE_TABLES_DEV[key]


def nibbles_major_np(le_bytes: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 little-endian scalar -> (NPOS, n) int32 nibbles,
    least significant first (position i carries weight 16^i).
    POSITION-MAJOR — the device layout, written directly."""
    cols = le_bytes.T  # (32, n) strided view
    out = np.empty((NPOS, le_bytes.shape[0]), dtype=np.int32)
    out[0::2] = cols & 0x0F
    out[1::2] = cols >> 4
    return out


def windows_major_np(le_bytes: np.ndarray, wbits: int) -> np.ndarray:
    """(n, 32) uint8 little-endian scalar -> (npos, n) int32 wbits-bit
    windows, least significant first, position-major (the shared
    fe.extract_windows_np decoder; w=4 keeps the cheaper nibble
    interleave). The top position's window is naturally truncated to the
    scalar's top bits."""
    if wbits == 4:
        return nibbles_major_np(le_bytes)
    return fe.extract_windows_np(le_bytes, wbits, npos_for(wbits))


_IDENT_LIMBS: Optional[np.ndarray] = None


def ref_identity_limbs() -> np.ndarray:
    """(4, 17) int32 limbs of the extended identity (0, 1, 1, 0)."""
    global _IDENT_LIMBS
    if _IDENT_LIMBS is None:
        _IDENT_LIMBS = np.stack(
            [fe._int_to_limbs_np(c % ref.P) for c in ref.IDENTITY]
        )
    return _IDENT_LIMBS


# ---------------------------------------------------------------------------
# Device pieces (limb-major, batch-minor)
# ---------------------------------------------------------------------------


def _unpack_element(words: torch.Tensor) -> torch.Tensor:
    """(9, ...) packed words -> (17, ...) limbs: lo | hi << 15 pairs for
    limbs 0..15, the 17th limb rides alone in word 8."""
    lo = words[:8] & 0x7FFF
    hi = (words[:8] >> 15) & 0x7FFF
    pairs = torch.stack([lo, hi], dim=1).reshape((16,) + tuple(words.shape[1:]))
    return torch.cat([pairs, words[8:9]], dim=0)


def _row_niels(rows: torch.Tensor):
    """Table rows (ROW, ...) -> (ypx, ymx, xy2d) limb tensors (17, ...).
    The layout is the rows' width: 32 words are packed, 64 dense."""
    if rows.shape[0] == ROW_PACKED:
        w = PACKED_WORDS
        return (_unpack_element(rows[0:w]), _unpack_element(rows[w : 2 * w]),
                _unpack_element(rows[2 * w : 3 * w]))
    n = fe.NLIMB
    return rows[:n], rows[n : 2 * n], rows[2 * n : 3 * n]


def negate_rows(rows: torch.Tensor) -> torch.Tensor:
    """Niels negation on dense rows (ROW, ...): swap (y+x, y−x), negate
    2dxy. Dense layout only — the comb path that needs it never runs
    packed (use_row_packing gates the fused path's tables)."""
    if PACKED or rows.shape[0] == ROW_PACKED:
        # unconditional (NOT an assert): under `python -O` a packed table
        # negated with dense-layout arithmetic would give wrong group
        # elements — and wrong verdicts — instead of failing loudly
        raise RuntimeError(
            "negate_rows is a dense-layout (comb-mode) helper; "
            "packed rows (use_row_packing) only feed the fused path"
        )
    ypx, ymx, xy2d = _row_niels(rows)
    return torch.cat([ymx, ypx, fe.neg(xy2d), rows[3 * fe.NLIMB :]], dim=0)


def _madd_tuple(x1, y1, z1, t1, rows):
    """Mixed add on coordinate tuples: extended (17, ...) x4 + Niels rows
    (ROW, ...). ref10-style ge_madd — 7 field muls + 1 mul_small."""
    ypx, ymx, xy2d = _row_niels(rows)
    a = fe.mul(fe.add(y1, x1), ypx)
    b = fe.mul(fe.sub(y1, x1), ymx)
    c = fe.mul(xy2d, t1)
    d = fe.mul_small(z1, 2)
    e = fe.sub(a, b)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(a, b)
    return fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h)


def madd(p: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Mixed add: extended (4, 17, ...) + Niels rows (ROW, ...)."""
    x, y, z, t = _madd_tuple(p[0], p[1], p[2], p[3], rows)
    return torch.stack([x, y, z, t], dim=0)


def accumulate_index(
    s_windows: torch.Tensor,
    k_windows: torch.Tensor,
    row_base: torch.Tensor,
    window: int = WINDOW,
) -> torch.Tensor:
    """(npos, B) int32 table-row index of every (position, lane):
    row_base + pos·W² + s·W + k."""
    npos = s_windows.shape[0]
    pos = torch.arange(npos, dtype=fe.DTYPE, device=s_windows.device)[:, None]
    return row_base[None, :] + pos * (window * window) + s_windows * window + k_windows


def wire_index_plain(
    wire: torch.Tensor, a_index: torch.Tensor, window: int = WINDOW
) -> torch.Tensor:
    """The plain version of wire mode's index math: (B, 96) uint8 wire
    bytes and (B,) int32 key rows -> (npos, B) int32 table rows, through
    `fe.extract_windows_dev` and `accumulate_index`."""
    wbits = window.bit_length() - 1
    npos = npos_for(wbits)
    s_w = fe.extract_windows_dev(wire[:, 0:32], wbits, npos)
    k_w = fe.extract_windows_dev(wire[:, 32:64], wbits, npos)
    return accumulate_index(s_w, k_w, a_index * (npos * window * window), window)


MAX_PARTS = 16  # threads a lane's positions split over, at most


def check_layout(*tables: torch.Tensor) -> None:
    """Every table (M, W) int32 is in the active layout (W == ROW), or
    raise: rows of the other width are garbage to the arithmetic."""
    for t in tables:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != ROW:
            raise ValueError(f"table must be (M, {ROW}) int32 in the active "
                             f"layout, got {tuple(t.shape)} {t.dtype}")


def _check_parts(parts: int) -> None:
    if parts < 1 or parts > MAX_PARTS or parts & (parts - 1):
        raise ValueError(f"parts must be a power of two <= {MAX_PARTS}, got {parts}")


def split_bounds(npos: int, parts: int):
    """[begin, end) positions of each of `parts` threads, as the kernel
    splits them: floor(j·npos/P) to floor((j+1)·npos/P). Parts differ by
    at most one position when P does not divide npos."""
    return [((j * npos) // parts, ((j + 1) * npos) // parts) for j in range(parts)]


def _accumulate_plain(streams, parts: int) -> torch.Tensor:
    """The plain version of the kernel's loop. `streams` lists (table
    (M, ROW), idx (npos, B), negate) in the order their rows are added at
    each position. Part j adds its positions' rows to the identity, in
    order; a part with a position fewer leaves its last step out. The
    partial sums then combine pairwise, (0+1), (2+3), … level by level,
    with `edwards.point_add`. The parts run side by side along the batch
    axis."""
    _check_parts(parts)
    npos, batch = streams[0][1].shape
    device = streams[0][1].device
    bounds = split_bounds(npos, parts)
    acc = torch.as_tensor(ref_identity_limbs(), device=device)[:, :, None]
    acc = acc.expand(4, fe.NLIMB, parts * batch)
    for i in range(max(hi - lo for lo, hi in bounds)):
        pos = torch.tensor([min(lo + i, npos - 1) for lo, _ in bounds], device=device)
        active = [lo + i < hi for lo, hi in bounds]
        mask = None
        if not all(active):
            mask = torch.tensor(active, device=device).repeat_interleave(batch)
        for table, idx, negate in streams:
            rows = table.index_select(0, idx[pos].reshape(-1)).T  # (ROW, P·B)
            nxt = madd(acc, negate_rows(rows) if negate else rows)
            acc = nxt if mask is None else torch.where(mask, nxt, acc)
    acc = acc.reshape(4, fe.NLIMB, parts, batch)
    while acc.shape[2] > 1:
        acc = edwards.point_add(acc[:, :, 0::2], acc[:, :, 1::2])
    return acc[:, :, 0]


def madd_loop_plain(idx: torch.Tensor, f_flat: torch.Tensor, parts: int = 1) -> torch.Tensor:
    """The plain PyTorch version of the accumulate kernel in index and
    wire mode. idx (npos, B) int32, f_flat (M, ROW) int32 in the active
    layout -> (4, 17, B) int32.

    The positions split over `parts` as the kernel splits them over a
    lane's threads (`split_bounds`). With parts=1 this is the sequential
    loop, limb-identical to the JAX package's accumulate in either layout;
    with more parts it is the same point in another projective
    representation."""
    check_layout(f_flat)
    return _accumulate_plain([(f_flat, idx, False)], parts)


def comb_index(s_nibbles: torch.Tensor, k_nibbles: torch.Tensor, a_row_base: torch.Tensor):
    """The comb's two (NPOS, B) row streams: the base table's row
    pos·W + s, and the key table's row a_row_base + pos·W + k."""
    pos = torch.arange(s_nibbles.shape[0], dtype=fe.DTYPE, device=s_nibbles.device)[:, None]
    return pos * WINDOW + s_nibbles, a_row_base[None, :] + pos * WINDOW + k_nibbles


def comb_accumulate_plain(
    s_nibbles: torch.Tensor,
    k_nibbles: torch.Tensor,
    a_row_base: torch.Tensor,
    a_flat: torch.Tensor,
    b_flat: torch.Tensor,
    parts: int = 1,
) -> torch.Tensor:
    """The plain PyTorch version of the accumulate kernel in comb mode:
    [S]B + [k](−A) through the separate comb tables, two rows and two
    mixed adds a position, the base table's row first, then the key's row
    negated (the JAX package's `comb_accumulate` loop). s_nibbles,
    k_nibbles (NPOS, B) int32, a_row_base (B,) int32 = key·NPOS·WINDOW,
    a_flat (n_keys·NPOS·WINDOW, ROW), b_flat (NPOS·WINDOW, ROW), dense
    rows -> (4, 17, B). Positions split over `parts` as in
    `madd_loop_plain`."""
    check_layout(a_flat, b_flat)
    b_idx, a_idx = comb_index(s_nibbles, k_nibbles, a_row_base)
    return _accumulate_plain([(b_flat, b_idx, False), (a_flat, a_idx, True)], parts)


def r_from_wire(wire: torch.Tensor):
    """(B, 96) wire bytes -> R's y as (17, B) int32 limbs (bit 255 left
    out) and R's sign bit as (B,) int32, as the verdict kernel reads
    them."""
    r_y = fe.extract_windows_dev(wire[:, 64:96], fe.RADIX, fe.NLIMB)
    return r_y, wire[:, 95].to(fe.DTYPE) >> 7


def encode_and_compare_plain(
    p: torch.Tensor,
    r_y: torch.Tensor,
    r_sign: torch.Tensor,
    precheck: torch.Tensor,
    affine: bool = False,
):
    """The plain PyTorch version of the verdict kernel: per-lane Fermat
    inversion of Z, affine x and y, and the JAX package's comparison
    (`_encode_and_compare`): canonical y equals R.y, x's parity equals R's
    sign, and the precheck holds. -> (B,) bool, and with affine=True also
    the canonical (x, y) limbs as one (2·17, B) int32 tensor."""
    zinv = fe.invert(p[2])
    x = fe.to_canonical(fe.mul(p[0], zinv))
    y = fe.to_canonical(fe.mul(p[1], zinv))
    ok = fe.eq(y, r_y) & (fe.parity(x) == r_sign) & precheck
    return (ok, torch.cat([x, y], dim=0)) if affine else ok


# ---------------------------------------------------------------------------
# The CUDA kernels (csrc/*.cu, sharing csrc/field25519.cuh), each built with
# nvcc at first use into the package's build directory and bound through
# ctypes.
# ---------------------------------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
# the headers every kernel may include: field25519.cuh, edwards25519.cuh,
# field25519_coop.cuh
HEADERS = tuple(os.path.join(_CSRC, h)
                for h in ("field25519.cuh", "edwards25519.cuh", "field25519_coop.cuh"))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


def _check_cuda(*tensors: torch.Tensor) -> torch.device:
    """All on one CUDA device and contiguous, or raise."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"kernel needs its tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel tensors must be contiguous")
    return dev


def _check_dtype(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")


class _CudaKernel:
    """Build-at-first-use and ctypes binding shared by the kernels.

    ``launches`` counts kernel launches of the path and ``launches_by``
    the same launches by configuration or entry; both grow only where a
    subclass launches its kernel (`_count`). ``build_log`` keeps nvcc's
    ``-Xptxas -v`` report (registers, spills) of the build this process
    made."""

    SOURCE = ""
    LIB_NAME = ""

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by = {}
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by = {}

    def _count(self, key: str) -> None:
        self.launches += 1
        self.launches_by[key] = self.launches_by.get(key, 0) + 1

    def library(self) -> ctypes.CDLL:
        """Build (if the source or a header is newer than the library)
        and load."""
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
            return self._lib

    def _build_and_load(self) -> ctypes.CDLL:
        from .. import build_dir

        so = os.path.join(build_dir(), self.LIB_NAME)
        newest = max(os.path.getmtime(p) for p in (self.SOURCE, *HEADERS))
        if not (os.path.exists(so) and os.path.getmtime(so) >= newest):
            # per-process temp name + atomic rename: concurrent builders
            # never load a half-written library
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.SOURCE],
                capture_output=True, text=True, timeout=600,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
                )
            os.replace(tmp, so)
            self.build_log = proc.stderr
        lib = ctypes.CDLL(so)
        self._bind(lib)
        return lib

    def _bind(self, lib: ctypes.CDLL) -> None:
        raise NotImplementedError

    @staticmethod
    def _raise_on(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


_P = ctypes.c_void_p


class FusedAccumulateKernel(_CudaKernel):
    """Wrapper of the accumulate kernel K1 (csrc/fused_accumulate.cu).

    Index mode (`__call__`) takes the (npos, B) row indices; wire mode
    (`wire`) takes the raw (B, 96) wire bytes and the key rows and works
    out the indices itself, at 4-, 5- or 6-bit windows; comb mode (`comb`)
    takes the nibbles, the key row bases and the two comb tables. Every
    mode reads dense or packed rows, the layout of the active `ROW`, and
    returns the (4·17, B) int32 accumulator in canonical 17×15 limbs,
    batch-minor.

    ``launches_by`` counts launches under `config_name` (mode, window,
    layout)."""

    SOURCE = os.path.join(_CSRC, "fused_accumulate.cu")
    LIB_NAME = "libfused_accumulate.so"
    MODES = {"index": 0, "wire": 1, "comb": 2}

    def __init__(self) -> None:
        super().__init__()
        self._resident = {}

    def _bind(self, lib: ctypes.CDLL) -> None:
        lib.fused_accumulate_launch.argtypes = [
            ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P,
            _P, ctypes.c_longlong, _P, ctypes.c_longlong,
            _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
        ]
        lib.fused_accumulate_launch.restype = ctypes.c_int
        lib.fused_accumulate_resident_threads.argtypes = [ctypes.c_int]
        lib.fused_accumulate_resident_threads.restype = ctypes.c_longlong

    def resident_threads(self, device: torch.device, packed: Optional[bool] = None) -> int:
        """Threads of K1 in the given layout (default: the active one)
        that `device` holds resident at once."""
        packed = PACKED if packed is None else packed
        index = device.index if device.index is not None else torch.cuda.current_device()
        key = (index, bool(packed))
        if key not in self._resident:
            lib = self.library()
            with torch.cuda.device(index):
                n = lib.fused_accumulate_resident_threads(int(packed))
            if n <= 0:
                raise RuntimeError(f"occupancy query failed: {n}")
            self._resident[key] = int(n)
        return self._resident[key]

    def parts_for(self, batch: int, device: torch.device, npos: int = NPOS,
                  packed: Optional[bool] = None) -> int:
        """P for a bucket: the largest power of two, at most MAX_PARTS and
        at most npos, with batch·P within the card's resident threads.
        When P does not divide npos, parts differ by one position
        (`split_bounds`)."""
        room = self.resident_threads(device, packed) // max(batch, 1)
        parts = 1
        while parts * 2 <= min(MAX_PARTS, room, npos):
            parts *= 2
        return parts

    def __call__(self, idx: torch.Tensor, f_flat: torch.Tensor) -> torch.Tensor:
        """Index mode: idx (npos, B) int32 -> (4·17, B) int32."""
        dev = _check_cuda(idx, f_flat)
        _check_dtype(idx, torch.int32, "idx")
        if idx.dim() != 2:
            raise ValueError(f"idx must be (npos, B), got {tuple(idx.shape)}")
        npos, batch = idx.shape
        return self._launch(dev, "index", wbits_for(npos), npos, batch, f_flat,
                            idx=idx.data_ptr())

    def wire(self, wire: torch.Tensor, a_index: torch.Tensor,
             f_flat: torch.Tensor, window: int = WINDOW) -> torch.Tensor:
        """Wire mode: wire (B, 96) uint8, a_index (B,) int32, windows of
        `window` = 2^wbits entries (wbits 4, 5 or 6) -> (4·17, B)."""
        dev = _check_cuda(wire, a_index, f_flat)
        _check_dtype(wire, torch.uint8, "wire")
        _check_dtype(a_index, torch.int32, "a_index")
        if wire.dim() != 2 or wire.shape[1] != 96 or a_index.shape != (wire.shape[0],):
            raise ValueError(f"shapes (B, 96), (B,) required, got "
                             f"{tuple(wire.shape)}, {tuple(a_index.shape)}")
        wbits = window.bit_length() - 1
        if window != 1 << wbits or wbits not in (4, 5, 6):
            raise ValueError(f"windows of 16, 32 or 64 entries, got {window}")
        return self._launch(dev, "wire", wbits, npos_for(wbits), wire.shape[0], f_flat,
                            wire=wire.data_ptr(), lane_key=a_index.data_ptr())

    def comb(self, s_nibbles: torch.Tensor, k_nibbles: torch.Tensor,
             a_row_base: torch.Tensor, a_flat: torch.Tensor,
             b_flat: torch.Tensor) -> torch.Tensor:
        """Comb mode: s_nibbles, k_nibbles (NPOS, B) int32, a_row_base (B,)
        int32, a_flat and b_flat dense rows -> (4·17, B)."""
        dev = _check_cuda(s_nibbles, k_nibbles, a_row_base, a_flat, b_flat)
        for t, what in ((s_nibbles, "s_nibbles"), (k_nibbles, "k_nibbles"),
                        (a_row_base, "a_row_base")):
            _check_dtype(t, torch.int32, what)
        if PACKED:
            raise RuntimeError("the comb mode reads dense rows; packed rows "
                               "(use_row_packing) only feed the fused path")
        batch = a_row_base.shape[0]
        if (s_nibbles.shape != (NPOS, batch) or k_nibbles.shape != (NPOS, batch)
                or a_row_base.dim() != 1):
            raise ValueError(f"shapes ({NPOS}, B), ({NPOS}, B), (B,) required, got "
                             f"{tuple(s_nibbles.shape)}, {tuple(k_nibbles.shape)}, "
                             f"{tuple(a_row_base.shape)}")
        check_layout(b_flat)
        if b_flat.shape[0] < NPOS * WINDOW:
            raise ValueError(f"base table must hold {NPOS * WINDOW} rows")
        return self._launch(dev, "comb", 4, NPOS, batch, a_flat,
                            s_win=s_nibbles.data_ptr(), k_win=k_nibbles.data_ptr(),
                            lane_key=a_row_base.data_ptr(), b_flat=b_flat)

    def _launch(self, dev, mode, wbits, npos, batch, f_flat, idx=None, wire=None,
                lane_key=None, s_win=None, k_win=None, b_flat=None):
        check_layout(f_flat)
        for t in (f_flat, b_flat):
            if t is not None and t.data_ptr() % 16:
                raise ValueError("tables must be 16-byte aligned (vector row loads)")
        if npos == 0 or batch == 0 or f_flat.shape[0] == 0:
            raise ValueError("empty accumulate")
        packed = ROW == ROW_PACKED
        parts = self.parts_for(batch, dev, npos, packed)
        lib = self.library()
        out = torch.empty((4 * fe.NLIMB, batch), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.fused_accumulate_launch(
                self.MODES[mode], int(packed), idx, wire, lane_key, s_win, k_win,
                f_flat.data_ptr(), f_flat.shape[0],
                None if b_flat is None else b_flat.data_ptr(),
                0 if b_flat is None else b_flat.shape[0],
                out.data_ptr(), npos, batch, parts.bit_length() - 1, wbits,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        self._raise_on(rc, "fused_accumulate")
        self._count(config_name("comb" if mode == "comb" else "fused", wbits, ROW))
        return out


class EncodeVerdictKernel(_CudaKernel):
    """Wrapper of the verdict kernel (csrc/encode_verdict.cu): per lane,
    Z's inverse, affine x and y, and the comparison with R's encoding —
    R's wire bytes (`__call__`, the fused path) or R's staged (17, B)
    limbs and (B,) sign (`limbs`, the comb path).

    ``launches_by`` counts launches under "wire" and "limbs"."""

    SOURCE = os.path.join(_CSRC, "encode_verdict.cu")
    LIB_NAME = "libencode_verdict.so"

    # 0-5: one thread an element (field25519.cuh, K1's and K9's arithmetic);
    # coop_*: a group of 5 threads an element (field25519_coop.cuh, the
    # verdict kernel's)
    FIELD_OPS = {"mul": 0, "sq": 1, "invert": 2, "canonical": 3, "pow22523": 4, "neg": 5,
                 "coop_mul": 6, "coop_sq": 7, "coop_invert": 8, "coop_pow22523": 9}

    def _bind(self, lib: ctypes.CDLL) -> None:
        lib.encode_verdict_launch.argtypes = [_P, _P, _P, _P, _P, ctypes.c_int, _P]
        lib.encode_verdict_launch.restype = ctypes.c_int
        lib.encode_verdict_limbs_launch.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_int, _P]
        lib.encode_verdict_limbs_launch.restype = ctypes.c_int
        lib.field_op_launch.argtypes = [ctypes.c_int, _P, _P, _P, ctypes.c_int, _P]
        lib.field_op_launch.restype = ctypes.c_int

    def __call__(self, acc: torch.Tensor, wire: torch.Tensor, precheck: torch.Tensor,
                 affine: bool = False):
        """acc (4·17, B) int32, wire (B, 96) uint8, precheck (B,) bool ->
        (B,) bool verdicts; with affine=True also the canonical (x, y)
        limbs, (2·17, B) int32."""
        dev = _check_cuda(acc, wire, precheck)
        _check_dtype(acc, torch.int32, "acc")
        _check_dtype(wire, torch.uint8, "wire")
        _check_dtype(precheck, torch.bool, "precheck")
        batch = wire.shape[0]
        if (acc.shape != (4 * fe.NLIMB, batch) or wire.shape != (batch, 96)
                or precheck.shape != (batch,) or batch == 0):
            raise ValueError(f"shapes (68, B), (B, 96), (B,) required, got "
                             f"{tuple(acc.shape)}, {tuple(wire.shape)}, {tuple(precheck.shape)}")
        if wire.data_ptr() % 16:
            raise ValueError("wire must be 16-byte aligned (vector loads of R)")
        lib = self.library()
        verdict = torch.empty((batch,), dtype=torch.bool, device=dev)
        xy = (torch.empty((2 * fe.NLIMB, batch), dtype=torch.int32, device=dev)
              if affine else None)
        with torch.cuda.device(dev):
            rc = lib.encode_verdict_launch(
                acc.data_ptr(), wire.data_ptr(), precheck.data_ptr(), verdict.data_ptr(),
                xy.data_ptr() if affine else None, batch,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        self._raise_on(rc, "encode_verdict")
        self._count("wire")
        return (verdict, xy) if affine else verdict

    def limbs(self, acc: torch.Tensor, r_y: torch.Tensor, r_sign: torch.Tensor,
              precheck: torch.Tensor, affine: bool = False):
        """The comb path's entry: acc (4·17, B) int32, R.y as (17, B) int32
        17×15 limbs, R's sign (B,) int32, precheck (B,) bool -> (B,) bool
        verdicts; with affine=True also the canonical (x, y) limbs."""
        dev = _check_cuda(acc, r_y, r_sign, precheck)
        _check_dtype(acc, torch.int32, "acc")
        _check_dtype(r_y, torch.int32, "r_y")
        _check_dtype(r_sign, torch.int32, "r_sign")
        _check_dtype(precheck, torch.bool, "precheck")
        batch = precheck.shape[0]
        if (acc.shape != (4 * fe.NLIMB, batch) or r_y.shape != (fe.NLIMB, batch)
                or r_sign.shape != (batch,) or precheck.dim() != 1 or batch == 0):
            raise ValueError(f"shapes (68, B), (17, B), (B,), (B,) required, got "
                             f"{tuple(acc.shape)}, {tuple(r_y.shape)}, "
                             f"{tuple(r_sign.shape)}, {tuple(precheck.shape)}")
        lib = self.library()
        verdict = torch.empty((batch,), dtype=torch.bool, device=dev)
        xy = (torch.empty((2 * fe.NLIMB, batch), dtype=torch.int32, device=dev)
              if affine else None)
        with torch.cuda.device(dev):
            rc = lib.encode_verdict_limbs_launch(
                acc.data_ptr(), r_y.data_ptr(), r_sign.data_ptr(), precheck.data_ptr(),
                verdict.data_ptr(), xy.data_ptr() if affine else None, batch,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        self._raise_on(rc, "encode_verdict_limbs")
        self._count("limbs")
        return (verdict, xy) if affine else verdict

    def field_op(self, op: str, a: torch.Tensor, b: Optional[torch.Tensor] = None):
        """Test entry for the field header on the card (not a launch of the
        path, so not counted): a, b (17, n) int32 17×15 limbs -> canonical
        (17, n) limbs of a·b, a², a⁻¹, a, a^(2^252 − 3) or −a, or of a·b,
        a², a⁻¹ and a^(2^252 − 3) computed by a group of threads
        (`coop_*`)."""
        b = a if b is None else b
        dev = _check_cuda(a, b)
        _check_dtype(a, torch.int32, "a")
        _check_dtype(b, torch.int32, "b")
        if a.dim() != 2 or a.shape[0] != fe.NLIMB or b.shape != a.shape or a.shape[1] == 0:
            raise ValueError(f"(17, n) operands required, got {tuple(a.shape)}, {tuple(b.shape)}")
        lib = self.library()
        out = torch.empty_like(a)
        with torch.cuda.device(dev):
            rc = lib.field_op_launch(self.FIELD_OPS[op], a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), a.shape[1],
                                     torch.cuda.current_stream(dev).cuda_stream)
        self._raise_on(rc, "field_op")
        return out


accumulate_kernel = FusedAccumulateKernel()
encode_kernel = EncodeVerdictKernel()


def fused_accumulate(
    s_windows: torch.Tensor,
    k_windows: torch.Tensor,
    row_base: torch.Tensor,
    f_flat: torch.Tensor,
    window: int = WINDOW,
) -> torch.Tensor:
    """[S]B + [k](−A) via the fused dual-scalar table: one row fetch + one
    mixed add per window position (64, 52 or 43 for 4-, 5- or 6-bit
    windows).

    s_windows, k_windows: (npos, B) int32. row_base: (B,) int32 =
    key_index * npos * window^2. f_flat: (n_keys*npos*window^2, ROW).
    -> (4, 17, B) extended coordinates.

    A CUDA tensor launches the kernel in index mode (canonical limbs); a
    CPU tensor runs the plain version with one part (the JAX package's
    limbs). There is no other route."""
    idx = accumulate_index(s_windows, k_windows, row_base, window)
    if idx.device.type == "cuda":
        out = accumulate_kernel(idx.contiguous(), f_flat)
        return out.reshape(4, fe.NLIMB, idx.shape[1])
    if idx.device.type == "cpu":
        return madd_loop_plain(idx, f_flat)
    raise ValueError(f"fused_accumulate runs on cuda or cpu, not {idx.device}")


def fused_accumulate_wire(
    wire: torch.Tensor, a_index: torch.Tensor, f_flat: torch.Tensor, window: int = WINDOW
) -> torch.Tensor:
    """[S]B + [k](−A) from the raw (B, 96) wire bytes and (B,) key rows ->
    (4, 17, B). A CUDA tensor launches the kernel in wire mode; a CPU
    tensor runs `wire_index_plain` and the plain accumulate with one
    part."""
    if wire.device.type == "cuda":
        return accumulate_kernel.wire(wire, a_index, f_flat, window).reshape(4, fe.NLIMB, -1)
    if wire.device.type == "cpu":
        return madd_loop_plain(wire_index_plain(wire, a_index, window), f_flat)
    raise ValueError(f"fused_accumulate_wire runs on cuda or cpu, not {wire.device}")


def comb_accumulate(
    s_nibbles: torch.Tensor,
    k_nibbles: torch.Tensor,
    a_row_base: torch.Tensor,
    a_flat: torch.Tensor,
    b_flat: torch.Tensor,
) -> torch.Tensor:
    """[S]B + [k](−A) via separate comb tables: two row fetches + two
    mixed adds per nibble position (128 madds in all).

    s_nibbles, k_nibbles: (NPOS, B) int32. a_row_base: (B,) int32 =
    key_index * NPOS * WINDOW. a_flat: (n_keys*NPOS*WINDOW, ROW). b_flat:
    (NPOS*WINDOW, ROW). -> (4, 17, B). A CUDA tensor launches the kernel
    in comb mode; a CPU tensor runs `comb_accumulate_plain` with one
    part."""
    if s_nibbles.device.type == "cuda":
        out = accumulate_kernel.comb(s_nibbles.contiguous(), k_nibbles.contiguous(),
                                     a_row_base.contiguous(), a_flat, b_flat)
        return out.reshape(4, fe.NLIMB, -1)
    if s_nibbles.device.type == "cpu":
        return comb_accumulate_plain(s_nibbles, k_nibbles, a_row_base, a_flat, b_flat)
    raise ValueError(f"comb_accumulate runs on cuda or cpu, not {s_nibbles.device}")


def encode_verdict(p: torch.Tensor, wire: torch.Tensor, precheck: torch.Tensor) -> torch.Tensor:
    """(4, 17, B) accumulator, (B, 96) wire bytes, (B,) precheck -> (B,)
    bool verdicts. A CUDA tensor launches the verdict kernel; a CPU tensor
    decodes R with `r_from_wire` and runs `encode_and_compare_plain`."""
    if p.device.type == "cuda":
        return encode_kernel(p.reshape(4 * fe.NLIMB, -1), wire, precheck)
    if p.device.type == "cpu":
        return encode_and_compare_plain(p, *r_from_wire(wire), precheck)
    raise ValueError(f"encode_verdict runs on cuda or cpu, not {p.device}")


def encode_verdict_limbs(
    p: torch.Tensor, r_y: torch.Tensor, r_sign: torch.Tensor, precheck: torch.Tensor
) -> torch.Tensor:
    """(4, 17, B) accumulator, R.y (17, B) int32 limbs, R's sign (B,)
    int32, (B,) precheck -> (B,) bool verdicts: the comb path's tail. A
    CUDA tensor launches the verdict kernel's limb entry; a CPU tensor
    runs `encode_and_compare_plain`."""
    if p.device.type == "cuda":
        return encode_kernel.limbs(p.reshape(4 * fe.NLIMB, -1), r_y.contiguous(),
                                   r_sign.contiguous(), precheck)
    if p.device.type == "cpu":
        return encode_and_compare_plain(p, r_y, r_sign, precheck)
    raise ValueError(f"encode_verdict_limbs runs on cuda or cpu, not {p.device}")


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(17, m), (17, m) -> (17, 2m) alternating a0 b0 a1 b1 ..."""
    return torch.stack([a, b], dim=2).reshape(a.shape[0], -1)


CHAIN_WIDTH = 128  # the tree stops at this many lanes: one Fermat chain
# costs the same launches at width 128 as at width 1


def batch_invert(z: torch.Tensor) -> torch.Tensor:
    """Tree-structured Montgomery batch inversion: (17, B) -> (17, B); the
    JAX package's inversion, kept as its counterpart (the device pass
    inverts per lane, `encode_and_compare_plain`).

    Pairwise products up the tree (log2(B/CHAIN_WIDTH) batched muls
    totalling ≈ B multiplies), ONE lane-parallel Fermat chain across the
    whole CHAIN_WIDTH-wide root level, then unfold back down (≈ 2B
    multiplies). Requires B a power of two and all inputs nonzero —
    guaranteed for Z coordinates of complete Edwards formulas.
    """
    n = z.shape[1]
    if n & (n - 1):
        raise ValueError(f"batch_invert requires a power-of-two batch, got {n}")
    levels = []
    cur = z
    while cur.shape[1] > CHAIN_WIDTH:
        levels.append(cur)
        cur = fe.mul(cur[:, 0::2], cur[:, 1::2])
    inv = fe.invert(cur)  # the only exponentiation chain
    for lev in reversed(levels):
        left, right = lev[:, 0::2], lev[:, 1::2]
        inv = _interleave(fe.mul(inv, right), fe.mul(inv, left))
    return inv


def _encode_and_compare(
    p: torch.Tensor, r_y: torch.Tensor, r_sign: torch.Tensor, precheck: torch.Tensor
) -> torch.Tensor:
    """Affine-normalize the accumulator (batch inversion) and compare its
    canonical encoding against R's wire bytes: the JAX package's tail,
    kept as its counterpart."""
    zinv = batch_invert(p[2])
    x_aff = fe.mul(p[0], zinv)
    y_aff = fe.mul(p[1], zinv)
    ok = fe.eq(y_aff, r_y) & (fe.parity(x_aff) == r_sign)
    return ok & precheck


def fused_verify_wire_kernel(
    wire: torch.Tensor,  # (B, 96) uint8 — S (32) ‖ k (32) ‖ R (32) raw bytes
    a_index: torch.Tensor,  # (B,) int32 — key row into the fused table bank
    f_table: torch.Tensor,  # (n_keys*npos*window^2, ROW) Niels rows
    precheck: torch.Tensor,  # (B,) bool — host-side validity mask
    window: int = WINDOW,
) -> torch.Tensor:
    """The device pass: RAW wire bytes, one packed (B, 96) uint8 tensor per
    batch, -> (B,) bool verdicts, so ~100 bytes per item cross the
    host->device link.

    On CUDA tensors it is exactly two launches: the accumulate kernel in
    wire mode (window extraction, index math, row gather and the npos
    mixed adds) and the verdict kernel (inversion, encoding, comparison).
    On CPU tensors it runs their plain versions."""
    p = fused_accumulate_wire(wire, a_index, f_table, window)
    return encode_verdict(p, wire, precheck)


def comb_verify_kernel(
    s_nibbles: torch.Tensor,  # (NPOS, B) int32 — S scalar nibbles
    k_nibbles: torch.Tensor,  # (NPOS, B) int32 — challenge scalar nibbles
    a_index: torch.Tensor,  # (B,) int32 — key row into the pubkey table bank
    a_table: torch.Tensor,  # (n_keys*NPOS*WINDOW, ROW) dense Niels rows
    b_table: torch.Tensor,  # (NPOS*WINDOW, ROW) dense rows (base point)
    r_y: torch.Tensor,  # (17, B) int32 — R's y limbs
    r_sign: torch.Tensor,  # (B,) int32 — R's x sign bit
    precheck: torch.Tensor,  # (B,) bool — host-side validity mask
) -> torch.Tensor:
    """Batched verify via combs: [S]B + [k](−A) must encode to R's bytes.
    On CUDA tensors two launches: the accumulate kernel in comb mode and
    the verdict kernel's limb entry; on CPU tensors their plain versions."""
    p = comb_accumulate(s_nibbles, k_nibbles, a_index * (NPOS * WINDOW), a_table, b_table)
    return encode_verdict_limbs(p, r_y, r_sign, precheck)
