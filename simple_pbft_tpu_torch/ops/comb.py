"""Fused comb-table Ed25519 verification engine, PyTorch + CUDA.

The algorithm is the JAX package's fused comb path, unchanged:

- **Pubkeys are a small committee set**, reused across every vote. The
  host decompresses each pubkey once (exact bigint math, or the native
  C++ builder) and uploads a per-key *fused table*:
  row[i*W² + ws*W + wk] = (ws·16^i) B + (wk·16^i) (−A), affine Niels form
  (y+x, y−x, 2dxy), for window positions i in 0..63 and nibbles ws, wk.
  [S]B + [k](−A) is then 64 table rows and 64 mixed adds — no doublings.
- **R never needs decompressing**: P = [S]B + [k](−A) is normalized to
  affine with ONE tree-structured batch inversion, and its canonical
  encoding (y limbs + x parity) is compared with R's wire bytes. A
  non-canonical or off-curve R simply never matches.

Tables are dense rows: one (64,) int32 row per Niels entry =
[y+x limbs | y−x limbs | 2dxy limbs | 13 pad], 256 bytes. Compute
tensors are limb-major / batch-minor ((17, B), see field25519.py).

The 64-position mixed-add accumulation is the hot loop. On a CUDA tensor
`fused_accumulate` launches the hand-written kernel in
``csrc/fused_accumulate.cu`` (one thread per signature, the four
coordinates in registers, table rows read straight from the bank); on a
CPU tensor it runs `madd_loop_plain`, the same arithmetic as PyTorch ops.
Both give limb-identical (4, 17, B) accumulators.

Everything stays constant-shape: 64 window positions whatever the scalar,
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

from . import field25519 as fe
from ..crypto import ed25519_cpu as ref

NPOS = 64  # 4-bit comb positions covering 256-bit scalars
WINDOW = 16
FWINDOW = WINDOW * WINDOW  # fused (s_nibble, k_nibble) window: 256 entries
ROW = 64  # Niels row: 3*17 int32 limbs + 13 pad to a 256B row


def npos_for(wbits: int) -> int:
    """Positions covering a 256-bit scalar with wbits-bit windows."""
    return -(-256 // wbits)


# ---------------------------------------------------------------------------
# Host-side table construction (exact Python bigints -> dense limb rows)
# ---------------------------------------------------------------------------


def _pack_rows_np(vals: np.ndarray) -> np.ndarray:
    """(n, 3, 17) int32 Niels limbs -> (n, ROW) dense rows: one int32 per
    limb, 13 pad words — a 256-byte row of which 204 bytes are payload."""
    n = vals.shape[0]
    out = np.zeros((n, ROW), dtype=np.int32)
    out[:, : 3 * fe.NLIMB] = vals.reshape(n, 3 * fe.NLIMB)
    return out


def _batch_affine_niels_np(points) -> np.ndarray:
    """Extended bigint points -> (n, ROW) dense Niels rows, with ONE
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


def _point_neg(p: ref.Point) -> ref.Point:
    x, y, z, t = p
    return ((-x) % ref.P, y, z, (-t) % ref.P)


def fused_table_np(point: ref.Point, wbits: int = 4) -> np.ndarray:
    """(npos * 4^wbits, ROW) dense rows for wbits-bit windows:
    row[i*FW + ws*2^w + wk] = (ws * 2^(w*i)) B + (wk * 2^(w*i)) (−A),
    FW = 4^wbits, npos = ceil(256/wbits).

    One row fetch + ONE mixed add per window position evaluates
    [S]B + [k](−A). At w=4 a key's table is 64 * 256 rows * 256 B =
    4 MiB; KeyBank caps how many keys live on the device.
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
    windows, least significant first, position-major."""
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


def _row_niels(rows: torch.Tensor):
    """Table rows (ROW, ...) -> (ypx, ymx, xy2d) limb tensors (17, ...)."""
    n = fe.NLIMB
    return rows[:n], rows[n : 2 * n], rows[2 * n : 3 * n]


def _madd_tuple(x1, y1, z1, t1, rows):
    """Mixed add on coordinate tuples: extended (17, ...) x4 + dense Niels
    rows (ROW, ...). ref10-style ge_madd — 7 field muls + 1 mul_small."""
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
    """Mixed add: extended (4, 17, ...) + dense Niels rows (ROW, ...)."""
    x, y, z, t = _madd_tuple(p[0], p[1], p[2], p[3], rows)
    return torch.stack([x, y, z, t], dim=0)


def _gather_rows(flat_table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One flat fetch of every position's row, staged position-major.

    flat_table: (M, ROW). idx: (npos, B) row indices. -> (npos, ROW, B).
    """
    npos, b = idx.shape
    rows = flat_table.index_select(0, idx.reshape(-1))  # (npos*B, ROW)
    return rows.reshape(npos, b, ROW).permute(0, 2, 1)


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


def madd_loop_plain(idx: torch.Tensor, f_flat: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the accumulate kernel: gather every
    position's row, then npos mixed adds from the identity.
    idx (npos, B) int32, f_flat (M, ROW) int32 -> (4, 17, B) int32."""
    rows_all = _gather_rows(f_flat, idx)
    acc = torch.as_tensor(ref_identity_limbs(), device=idx.device)[:, :, None]
    acc = acc.expand(4, fe.NLIMB, idx.shape[1])
    for i in range(idx.shape[0]):
        acc = madd(acc, rows_all[i])
    return acc


# ---------------------------------------------------------------------------
# The CUDA kernel (csrc/fused_accumulate.cu), built with nvcc at first use
# into the package's build directory and bound through ctypes.
# ---------------------------------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
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


class FusedAccumulateKernel:
    """Wrapper of the hand-written CUDA accumulate kernel.

    ``launches`` counts kernel launches — the only place it grows is the
    launch below, so a run can prove its device passes went through the
    kernel. ``build_log`` keeps nvcc's ``-Xptxas -v`` report (registers,
    spills) of the build this process made."""

    SOURCE = os.path.join(_CSRC, "fused_accumulate.cu")
    LIB_NAME = "libfused_accumulate.so"

    def __init__(self) -> None:
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def library(self) -> ctypes.CDLL:
        """Build (if the source is newer than the library) and load."""
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
            return self._lib

    def _build_and_load(self) -> ctypes.CDLL:
        from .. import build_dir

        so = os.path.join(build_dir(), self.LIB_NAME)
        if not (os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(self.SOURCE)):
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
        lib.fused_accumulate_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ]
        lib.fused_accumulate_launch.restype = ctypes.c_int
        return lib

    def __call__(self, idx: torch.Tensor, f_flat: torch.Tensor) -> torch.Tensor:
        """idx (npos, B) int32, f_flat (M, ROW) int32, both contiguous on
        one CUDA device -> (4·17, B) int32 accumulator, batch-minor."""
        if idx.device.type != "cuda" or f_flat.device != idx.device:
            raise ValueError(
                f"kernel needs both tensors on one CUDA device, got "
                f"{idx.device} and {f_flat.device}"
            )
        if idx.dtype != torch.int32 or f_flat.dtype != torch.int32:
            raise TypeError(f"int32 tensors required, got {idx.dtype}, {f_flat.dtype}")
        if idx.dim() != 2 or f_flat.dim() != 2 or f_flat.shape[1] != ROW:
            raise ValueError(f"shapes (npos, B), (M, {ROW}) required, got "
                             f"{tuple(idx.shape)}, {tuple(f_flat.shape)}")
        if not (idx.is_contiguous() and f_flat.is_contiguous()):
            raise ValueError("kernel tensors must be contiguous")
        if f_flat.data_ptr() % 16:
            raise ValueError("table must be 16-byte aligned (vector row loads)")
        npos, batch = idx.shape
        if npos == 0 or batch == 0 or f_flat.shape[0] == 0:
            raise ValueError("empty accumulate")
        lib = self.library()
        out = torch.empty((4 * fe.NLIMB, batch), dtype=torch.int32, device=idx.device)
        with torch.cuda.device(idx.device):
            stream = torch.cuda.current_stream(idx.device).cuda_stream
            rc = lib.fused_accumulate_launch(
                idx.data_ptr(), f_flat.data_ptr(), out.data_ptr(),
                npos, batch, f_flat.shape[0], stream,
            )
        if rc != 0:
            raise RuntimeError(f"fused_accumulate launch failed: CUDA error {rc}")
        self.launches += 1
        return out


accumulate_kernel = FusedAccumulateKernel()


def fused_accumulate(
    s_windows: torch.Tensor,
    k_windows: torch.Tensor,
    row_base: torch.Tensor,
    f_flat: torch.Tensor,
    window: int = WINDOW,
) -> torch.Tensor:
    """[S]B + [k](−A) via the fused dual-scalar table: one row fetch + one
    mixed add per window position (64 for 4-bit windows).

    s_windows, k_windows: (npos, B) int32. row_base: (B,) int32 =
    key_index * npos * window^2. f_flat: (n_keys*npos*window^2, ROW).
    -> (4, 17, B) extended coordinates.

    A CUDA tensor launches the hand-written kernel; a CPU tensor runs the
    plain version. There is no other route."""
    idx = accumulate_index(s_windows, k_windows, row_base, window)
    if idx.device.type == "cuda":
        out = accumulate_kernel(idx.contiguous(), f_flat)
        return out.reshape(4, fe.NLIMB, idx.shape[1])
    if idx.device.type == "cpu":
        return madd_loop_plain(idx, f_flat)
    raise ValueError(f"fused_accumulate runs on cuda or cpu, not {idx.device}")


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(17, m), (17, m) -> (17, 2m) alternating a0 b0 a1 b1 ..."""
    return torch.stack([a, b], dim=2).reshape(a.shape[0], -1)


CHAIN_WIDTH = 128  # the tree stops at this many lanes: one Fermat chain
# costs the same launches at width 128 as at width 1


def batch_invert(z: torch.Tensor) -> torch.Tensor:
    """Tree-structured Montgomery batch inversion: (17, B) -> (17, B).

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
    canonical encoding against R's wire bytes."""
    zinv = batch_invert(p[2])
    x_aff = fe.mul(p[0], zinv)
    y_aff = fe.mul(p[1], zinv)
    ok = fe.eq(y_aff, r_y) & (fe.parity(x_aff) == r_sign)
    return ok & precheck


def fused_verify_kernel(
    s_windows: torch.Tensor,  # (npos, B) int32 — S scalar windows
    k_windows: torch.Tensor,  # (npos, B) int32 — challenge scalar windows
    a_index: torch.Tensor,  # (B,) int32 — key row into the fused table bank
    f_table: torch.Tensor,  # (n_keys*npos*window^2, ROW) dense Niels rows
    r_y: torch.Tensor,  # (17, B) int32 — R's canonical y limbs
    r_sign: torch.Tensor,  # (B,) int32 — R's x sign bit
    precheck: torch.Tensor,  # (B,) bool — host-side validity mask
    window: int = WINDOW,  # 2^wbits entries per scalar per position
) -> torch.Tensor:
    """Batched verify via the fused comb: one row fetch + one madd per
    window position."""
    npos = s_windows.shape[0]
    p = fused_accumulate(
        s_windows,
        k_windows,
        a_index * (npos * window * window),
        f_table,
        window=window,
    )
    return _encode_and_compare(p, r_y, r_sign, precheck)


def fused_verify_wire_kernel(
    wire: torch.Tensor,  # (B, 96) uint8 — S (32) ‖ k (32) ‖ R (32) raw bytes
    a_index: torch.Tensor,  # (B,) int32 — key row into the fused table bank
    f_table: torch.Tensor,  # (n_keys*npos*window^2, ROW) dense Niels rows
    precheck: torch.Tensor,  # (B,) bool — host-side validity mask
    window: int = WINDOW,
) -> torch.Tensor:
    """fused_verify_kernel taking RAW wire bytes, one packed (B, 96)
    uint8 tensor per batch: scalar-window extraction, R limb decomposition
    and the sign bit all happen on the device (fe.extract_windows_dev), so
    ~100 bytes per item cross the host->device link."""
    wbits = window.bit_length() - 1
    npos = npos_for(wbits)
    s_w = fe.extract_windows_dev(wire[:, 0:32], wbits, npos)
    k_w = fe.extract_windows_dev(wire[:, 32:64], wbits, npos)
    r_y = fe.extract_windows_dev(wire[:, 64:96], fe.RADIX, fe.NLIMB)
    r_sign = wire[:, 95].to(fe.DTYPE) >> 7
    return fused_verify_kernel(
        s_w, k_w, a_index, f_table, r_y, r_sign, precheck, window=window,
    )
