"""Batched Ed25519 verification on a CUDA device — the port's verify path.

The counterpart of the JAX package's ``crypto/tpu_verifier.py`` in its
fused and comb modes: the fused comb engine with 4-, 5- or 6-bit windows
(4 is the default) over dense or packed table rows (`comb.use_row_packing`),
or the separate-table comb with 4-bit windows:

- The consensus plane drains every pending (pubkey, message, signature)
  tuple into one batch.
- Host prep is vectorized: wire bytes are decoded with numpy (one join +
  frombuffer per batch), the challenge scalars k = SHA-512(R||A||M) mod L
  come from the native batch hasher, and the S >= L / R.y >= p prechecks
  are numpy compares. The device receives ~100 raw bytes per item.
- One device pass per batch (ops/comb.fused_verify_wire_kernel, or
  comb_verify_kernel in comb mode): on a CUDA device two hand-written
  kernels, the accumulate kernel (in wire mode: window extraction, row
  gather, the mixed adds; in comb mode the same over two tables, from
  nibbles the host extracts) and the verdict kernel (per-lane inversion,
  encoding, comparison).
- Batches are padded to bucketed sizes (powers of two), so a device pass
  sees a handful of shapes; the verdict bitmap maps back per item, so
  one bad signature never poisons a quorum.

Verification equation (cofactorless, RFC 8032 permits): [S]B == R + [k]A,
rearranged to [S]B + [k](−A) == R.

The ladder mode (`mode="ladder"`) keeps no key bank: the host stages A's
and R's y limbs and signs and the bits of S and k (`prepare_batch`, the
JAX package's arrays byte for byte), and one hand-written kernel (K9,
ops/ladder.py) decompresses A and R on the device and runs a 256-step
Straus ladder per item (`verify_kernel`; its plain version is
`verify_kernel_plain`, both imported here under the JAX package's names).
It serves key sets of any size.

With ``mesh=`` (parallel/mesh.py, the counterpart of the JAX package's
``TpuVerifier(mesh=...)``) a pass splits the batch over the mesh's
devices and runs the mode's kernels on each shard.

The verifier runs on CUDA unless constructed with ``device="cpu"`` (the
tests do); without a CUDA device it raises instead of falling back.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import native, resolve_device
from ..ops import comb
from ..ops import field25519 as fe
from ..ops import ladder
from ..ops.ladder import verify_kernel, verify_kernel_plain  # noqa: F401 (the JAX names)
from ..parallel.mesh import Mesh, P, gather, shard_map
from . import ed25519_cpu as ref
from .verifier import BatchItem

log = logging.getLogger(__name__)

# Bucketed batch sizes: drained pools are padded up to the next bucket.
BUCKETS = (8, 32, 128, 512, 2048, 8192)

WINDOW_BITS = 4  # the default window: the fused w=4 comb, 64 positions

_L_BYTES = ref.L.to_bytes(32, "little")

_ZERO32 = bytes(32)
_ZERO64 = bytes(64)


# ---------------------------------------------------------------------------
# Host-side batch preparation (numpy + native hashing; no per-item Python
# beyond dict lookups and byte-string joins)
# ---------------------------------------------------------------------------


def _ge_p_np(y_bytes: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 little-endian, bit 255 ignored -> (n,) bool: is the
    encoded y non-canonical (y >= p)? p = 2^255 - 19, so y >= p iff bits
    1..254 are all ones and the low byte is >= 0xed."""
    mid_all_ones = (y_bytes[:, 1:31] == 0xFF).all(axis=1)
    top_ok = (y_bytes[:, 31] & 0x7F) == 0x7F
    low_ok = y_bytes[:, 0] >= 0xED
    return mid_all_ones & top_ok & low_ok


def _ge_l_np(s_bytes: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 little-endian -> (n,) bool: S >= L (non-canonical,
    malleable — reject). Lexicographic compare from the most significant
    byte down, vectorized."""
    l_arr = np.frombuffer(_L_BYTES, dtype=np.uint8)
    gt = np.zeros(len(s_bytes), dtype=bool)
    undecided = np.ones(len(s_bytes), dtype=bool)
    for i in range(31, -1, -1):
        b = s_bytes[:, i]
        gt |= undecided & (b > l_arr[i])
        undecided &= b == l_arr[i]
    return gt | undecided  # equal counts as >= L


def _bits_msb_first_np(le_bytes: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 little-endian scalar -> (n, 256) int32 bits MSB
    first — the ladder consumes the scalar top bit down."""
    bits = np.unpackbits(le_bytes, axis=-1, bitorder="little")  # LSB first
    return bits[:, ::-1].astype(np.int32)


def _split_items(items: Sequence[BatchItem]):
    """Items -> (pub (n,32), r (n,32), s (n,32), msgs list, wellformed
    (n,) bool) with malformed rows zeroed — one join per field, no
    per-item numpy."""
    n = len(items)
    ok = np.ones(n, dtype=bool)
    pubs: List[bytes] = []
    sigs: List[bytes] = []
    msgs: List[bytes] = []
    for i, it in enumerate(items):
        good = len(it.pubkey) == 32 and len(it.sig) == 64
        if not good:
            ok[i] = False
        pubs.append(it.pubkey if good else _ZERO32)
        sigs.append(it.sig if good else _ZERO64)
        msgs.append(it.msg)
    pub = np.frombuffer(b"".join(pubs), dtype=np.uint8).reshape(n, 32)
    sig = np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(n, 64)
    return pub, sig[:, :32], sig[:, 32:], msgs, ok


def _kernel_launches() -> Dict[str, int]:
    """The process's launch counts of the device passes' kernels."""
    return {"fused_accumulate": comb.accumulate_kernel.launches,
            "encode_verdict": comb.encode_kernel.launches,
            "ladder_verify": ladder.ladder_kernel.launches}


def _bucket_size(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


class KeyBank:
    """Cache of per-pubkey comb tables (the committee's key set).

    PBFT pubkeys are few and endlessly reused, so each is decompressed and
    expanded into Niels rows once on the host and kept on the verifier's
    device. The bank's capacity grows in powers of two. In fused mode a
    key's table has npos_for(window) * 4^window rows, in comb mode
    NPOS * WINDOW; the row width is `comb.ROW` as it stands when the bank
    is built (dense or packed), and stays so.

    `max_keys` bounds the bank: a Byzantine sender must not be able to
    grow device memory by spraying fresh valid curve points through the
    Verifier seam. The default is the JAX bank's, the same on every
    device: 1,024 keys in comb mode, and in fused mode as many keys as
    fit in about 2 GiB of tables in this window and layout. Keys beyond
    the cap report UNCACHED and are verified on the CPU fallback path.
    """

    UNCACHED = -2

    def __init__(
        self,
        initial_capacity: int = 8,
        max_keys: Optional[int] = None,
        device="cuda",
        mode: str = "comb",
        window: int = WINDOW_BITS,
    ):
        if mode not in ("comb", "fused"):
            raise ValueError(f"mode must be comb|fused, got {mode!r}")
        if window not in (4, 5, 6):
            raise ValueError(f"window must be 4|5|6, got {window!r}")
        if mode == "comb" and window != 4:
            raise ValueError("comb mode is fixed at 4-bit windows")
        self.window = window
        self.device = resolve_device(device)
        self.row = comb.ROW
        if mode == "comb":
            self._make_table = comb.comb_table_np
            self._rows_per_key = comb.NPOS * comb.WINDOW
            default_max = 1024  # ~260 KB a key
        else:
            self._make_table = lambda pt: comb.fused_table_np(pt, window)
            self._rows_per_key = comb.npos_for(window) * (1 << (2 * window))
            # about 2 GiB of tables whatever the window and layout (w=4
            # dense: ~4.2 MB a key -> 512 keys; w=5: 157; w=6: 46; packed
            # rows twice as many): an n = 256 committee and its clients
            # are 264 keys, and a tighter cap pushes the client keys,
            # registered last and signing every request, onto the CPU
            default_max = max(8, (2 << 30) // (self._rows_per_key * self.row * 4))
        self._index: Dict[bytes, int] = {}
        self._invalid_cache: set = set()
        self._max_keys = default_max if max_keys is None else max_keys
        # clamp: capacity beyond max_keys would allocate table memory the
        # lookup path refuses to ever use
        self._cap = max(1, min(initial_capacity, self._max_keys))
        self._np = np.zeros((self._cap, self._rows_per_key, self.row), np.int32)
        self._dev: Optional[torch.Tensor] = None
        self._replicas: Dict[torch.device, torch.Tensor] = {}
        self._dirty = True
        # the replica pipeline verifies sweep k+1 in a second worker thread
        # while sweep k is in flight — bank mutation must be atomic or two
        # first-sighted pubkeys can race `len(self._index)` and share a
        # table row (one key permanently verifying against the wrong point)
        self._lock = threading.Lock()

    @classmethod
    def from_numpy(
        cls,
        rows: np.ndarray,
        index: Dict[bytes, int],
        device="cuda",
        max_keys: Optional[int] = None,
        mode: str = "comb",
        window: int = WINDOW_BITS,
    ) -> "KeyBank":
        """A bank holding `rows` ((cap, rows_per_key, ROW) int32 tables of
        this mode, window and the active layout) under `index` (pubkey ->
        row) — exactly a JAX KeyBank's ``_np`` and ``_index``, so the two
        verify the same keys alike."""
        bank = cls(initial_capacity=1, max_keys=max_keys, device=device, mode=mode,
                   window=window)
        want = (bank._rows_per_key, bank.row)
        if rows.ndim != 3 or rows.shape[1:] != want or rows.dtype != np.int32:
            raise ValueError(
                f"rows must be (cap, {want[0]}, {want[1]}) int32, got "
                f"{rows.shape} {rows.dtype}"
            )
        cap = rows.shape[0]
        slots = sorted(index.values())
        if slots != list(range(len(slots))) or len(slots) > cap:
            raise ValueError("index must map keys to rows 0..n-1 of the bank")
        if cap > bank._max_keys:
            raise ValueError(f"bank of {cap} keys exceeds max_keys={bank._max_keys}")
        bank._cap = cap
        bank._np = np.ascontiguousarray(rows)
        bank._index = dict(index)
        return bank

    def lookup(self, pubkey: bytes) -> int:
        """-> table row for pubkey, -1 if the key is invalid (bad length /
        not a curve point), or UNCACHED if the bank is full. Builds and
        caches the table on miss. Thread-safe."""
        with self._lock:
            idx = self._index.get(pubkey)
            if idx is not None:
                return idx
            if len(pubkey) != 32 or pubkey in self._invalid_cache:
                return -1
        # table construction runs outside the lock, re-checking on re-entry
        pt = ref.point_decompress(pubkey)
        if pt is None:
            with self._lock:
                if len(self._invalid_cache) < 4096:  # bounded negative cache
                    self._invalid_cache.add(pubkey)
            return -1
        table = self._make_table(pt)
        with self._lock:
            idx = self._index.get(pubkey)
            if idx is not None:  # raced: another thread built it first
                return idx
            idx = len(self._index)
            if idx >= self._max_keys:
                return self.UNCACHED
            if idx >= self._cap:
                self._cap = min(self._cap * 2, self._max_keys)
                grown = np.zeros((self._cap,) + self._np.shape[1:], np.int32)
                grown[:idx] = self._np[:idx]
                self._np = grown
            self._np[idx] = table
            self._index[pubkey] = idx
            self._dirty = True
            return idx

    def lookup_many(self, items: Sequence[BatchItem]) -> "tuple[np.ndarray, np.ndarray, List[int]]":
        """Resolve every item's pubkey row in one pass: -> (a_idx (n,)
        int32, hit (n,) bool, fallback positions). One lock acquisition
        covers the hit path; misses take the slow build path."""
        n = len(items)
        a_idx = np.zeros(n, dtype=np.int32)
        hit = np.ones(n, dtype=bool)
        fallback: List[int] = []
        misses: List[int] = []
        with self._lock:
            index = self._index
            for i, it in enumerate(items):
                idx = index.get(it.pubkey)
                if idx is not None:
                    a_idx[i] = idx
                else:
                    misses.append(i)
        for i in misses:
            idx = self.lookup(items[i].pubkey)
            if idx >= 0:
                a_idx[i] = idx
            else:
                hit[i] = False
                if idx == KeyBank.UNCACHED:
                    fallback.append(i)
        return a_idx, hit, fallback

    def device_tables(self, device=None) -> torch.Tensor:
        """Flat (cap * rows_per_key, ROW) int32 table on the bank's device,
        or on `device` (a mesh's other device: a copy of it), uploaded again
        only after the bank changed. An upload drops every copy, so no
        device keeps a table older than the bank."""
        with self._lock:
            if self._dirty or self._dev is None:
                self._dev = torch.from_numpy(
                    self._np.reshape(self._cap * self._rows_per_key, self.row)
                ).to(self.device)
                self._replicas = {}
                self._dirty = False
            if device is None or torch.device(device) == self.device:
                return self._dev
            device = torch.device(device)
            if device not in self._replicas:
                self._replicas[device] = self._dev.to(device, copy=True)
            return self._replicas[device]


def _pad_batch_arrays(arrays, n: int, size: int):
    """Zero-pad each array's TRAILING (batch) dim from n to size."""
    if size < n:
        raise ValueError(f"pad target {size} < batch {n}")
    pad = size - n

    def pz(a):
        widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
        return np.pad(a, widths)

    return tuple(pz(a) for a in arrays)


class PreparedBatch:
    """Fixed-shape device-ready arrays of the ladder mode for one batch of
    size n (pre-padding). Field order matches verify_kernel's signature;
    the batch axis is trailing on every array."""

    __slots__ = ("n", "a_y", "a_sign", "r_y", "r_sign", "s_bits", "k_bits", "precheck")

    def __init__(self, n, a_y, a_sign, r_y, r_sign, s_bits, k_bits, precheck):
        self.n = n
        self.a_y = a_y
        self.a_sign = a_sign
        self.r_y = r_y
        self.r_sign = r_sign
        self.s_bits = s_bits
        self.k_bits = k_bits
        self.precheck = precheck

    def arrays(self):
        return (self.a_y, self.a_sign, self.r_y, self.r_sign, self.s_bits, self.k_bits,
                self.precheck)

    def padded(self, size: int) -> "PreparedBatch":
        """Zero-pad every array's batch dim up to `size`. Padding rows get
        precheck=False, so their (garbage) device verdicts are masked out."""
        if size == self.n:
            return self
        return PreparedBatch(self.n, *_pad_batch_arrays(self.arrays(), self.n, size))


def prepare_batch(items: Sequence[BatchItem]) -> PreparedBatch:
    """Wire bytes -> the ladder mode's fixed-shape numpy arrays and host
    precheck mask: A's and R's y limbs (17, n) and signs (n,), S's and k's
    bits (256, n) MSB first, the precheck (n,).

    Malformed items (wrong lengths) stay in the batch as dummy rows with
    precheck=False — keeping shapes static is cheaper than compacting.
    """
    pub, r_raw, s_raw, msgs, ok = _split_items(items)
    k_le = native.challenge_batch(r_raw, pub, msgs)

    # host-detectable rejects: non-canonical S, non-canonical y encodings
    ok &= ~_ge_l_np(s_raw)
    ok &= ~_ge_p_np(pub)
    ok &= ~_ge_p_np(r_raw)

    return PreparedBatch(
        len(items),
        fe.bytes32_to_limbs_major_np(pub),
        fe.sign_bits_np(pub),
        fe.bytes32_to_limbs_major_np(r_raw),
        fe.sign_bits_np(r_raw),
        np.ascontiguousarray(_bits_msb_first_np(s_raw).T),
        np.ascontiguousarray(_bits_msb_first_np(k_le).T),
        ok,
    )


class CombBatch:
    """Device-ready arrays for the comb kernels (pre-padding); batch axis
    trailing on every array."""

    __slots__ = ("n", "s_nib", "k_nib", "a_idx", "r_y", "r_sign", "precheck")

    def __init__(self, n, s_nib, k_nib, a_idx, r_y, r_sign, precheck):
        self.n = n
        self.s_nib = s_nib
        self.k_nib = k_nib
        self.a_idx = a_idx
        self.r_y = r_y
        self.r_sign = r_sign
        self.precheck = precheck

    def arrays(self):
        return (self.s_nib, self.k_nib, self.a_idx, self.r_y, self.r_sign, self.precheck)

    def padded(self, size: int) -> "CombBatch":
        """Zero-pad every array's batch dim up to `size`; pad rows carry
        precheck=False, so their verdicts are masked out."""
        if size == self.n:
            return self
        return CombBatch(self.n, *_pad_batch_arrays(self.arrays(), self.n, size))


class WireBatch:
    """Raw-bytes staging for the fused wire kernel: one packed (n, 96)
    uint8 array (S ‖ k ‖ R per row) plus key rows and the precheck mask."""

    def __init__(self, n: int, wire: np.ndarray, a_idx: np.ndarray,
                 precheck: np.ndarray):
        self.n = n
        self._arrays = (wire, a_idx, precheck)

    def arrays(self):
        return self._arrays

    def padded(self, size: int) -> "WireBatch":
        """Zero-pad the batch (leading) dim up to `size`; keeps n = the
        pre-pad item count (pad rows carry precheck=False)."""
        if size == self.n:
            return self
        wire, a_idx, precheck = self._arrays
        pad = size - self.n
        if pad < 0:
            raise ValueError(f"pad target {size} < batch {self.n}")
        return WireBatch(
            self.n,
            np.pad(wire, ((0, pad), (0, 0))),
            np.pad(a_idx, (0, pad)),
            np.pad(precheck, (0, pad)),
        )


def _decode_and_precheck(items: Sequence[BatchItem], bank: KeyBank):
    """Wire-byte split, bank lookup, native challenge scalars, and the
    canonicality reject policy (S >= L malleability, non-canonical R.y).
    -> (s_raw, k_raw, r_raw, a_idx, ok, fallback)."""
    pub, r_raw, s_raw, msgs, ok = _split_items(items)
    a_idx, hit, fallback = bank.lookup_many(items)
    ok &= hit

    k_raw = native.challenge_batch(r_raw, pub, msgs)

    ok &= ~_ge_l_np(s_raw)
    ok &= ~_ge_p_np(r_raw)
    return s_raw, k_raw, r_raw, a_idx, ok, fallback


def prepare_comb_batch(
    items: Sequence[BatchItem], bank: KeyBank
) -> "tuple[CombBatch, List[int]]":
    """Wire bytes -> comb-kernel arrays, registering pubkeys in `bank`:
    the scalars' windows at the bank's width, the key rows, R.y's limbs
    and sign, and the precheck. Returns (batch, fallback): `fallback`
    lists item positions whose pubkey is valid but over the bank's cap —
    the caller verifies those on the CPU path (their device rows are
    masked out)."""
    n = len(items)
    s_raw, k_raw, r_raw, a_idx, ok, fallback = _decode_and_precheck(items, bank)
    batch = CombBatch(
        n,
        comb.windows_major_np(s_raw, bank.window),
        comb.windows_major_np(k_raw, bank.window),
        a_idx,
        fe.bytes32_to_limbs_major_np(r_raw),
        fe.sign_bits_np(r_raw),
        ok,
    )
    return batch, fallback


def prepare_wire_batch(
    items: Sequence[BatchItem], bank: KeyBank
) -> "tuple[WireBatch, List[int]]":
    """Wire bytes -> WireBatch for the fused wire kernel. Returns (batch,
    fallback): `fallback` lists item positions whose pubkey is valid but
    over the bank's cap — the caller verifies those on the CPU path
    (their device rows are masked out)."""
    n = len(items)
    s_raw, k_raw, r_raw, a_idx, ok, fallback = _decode_and_precheck(items, bank)
    wire = np.concatenate([s_raw, k_raw, r_raw], axis=1)  # (n, 96) uint8
    return WireBatch(n, wire, a_idx.astype(np.int32), ok), fallback


def _mesh_specs(mode: str, axis: str):
    """The JAX TpuVerifier's mesh splits of the staged arrays, in their
    order, then the bank's tables: the fused path's wire rows lead with the
    batch, the comb's and the ladder's limb-, position- and bit-major
    arrays trail with it; tables replicate."""
    vec, mat = P(axis), P(None, axis)
    staged = {"fused": (P(axis, None), vec, vec),
              "comb": (mat, mat, vec, mat, vec, vec),
              "ladder": (mat, vec, mat, vec, mat, mat, vec)}[mode]
    return staged + (P(),)


# One device pass at a time, process-wide. The replica runtime calls
# verify_batch from worker threads; the lock serializes the enqueue of a
# pass's kernels (a single device executes them in order anyway).
_DEVICE_LOCK = threading.Lock()


class GpuVerifier:
    """The `gpu` backend behind the crypto.Verifier seam, on a CUDA device.

    Default mode is the fused comb engine (cached per-pubkey dual-scalar
    tables, zero doublings, no on-device decompression, one madd per
    window position) with `window`-bit windows (4, 5 or 6); `mode="comb"`
    keeps a 4-bit table of each key alone and a constant one of the base
    point, for twice the madds; `mode="ladder"` keeps no key bank and
    decompresses every key on the device (the self-contained Straus
    ladder, for unbounded key sets). Table rows are dense or packed as
    `comb.ROW` stands when the verifier is built.

    Pads drained batches to bucketed sizes, runs one device pass per
    chunk, and returns the per-item bitmap.

    With a `mesh` (parallel/mesh.py) a pass splits the batch over the
    mesh's devices and runs the mode's kernels on each shard, on its
    device, as the JAX TpuVerifier(mesh=...) does: the staged per-item
    arrays are split along the batch, the bank's tables (and comb's base
    table) replicated, one copy a distinct device. The bank lives on the
    mesh's first device, whose type `device` must name; batches pad to at
    least the mesh size, which must be a power of two. Without a mesh the
    verifier runs on a mesh of its one device.
    """

    name = "gpu"

    def __init__(
        self,
        device="cuda",
        mode: str = "fused",
        window: int = WINDOW_BITS,
        initial_keys: Optional[int] = None,
        mesh: Optional[Mesh] = None,
    ):
        if mode not in ("comb", "fused", "ladder"):
            raise ValueError(f"mode must be comb|fused|ladder, got {mode!r}")
        if window != WINDOW_BITS and mode != "fused":
            raise ValueError("window is a fused-mode knob")
        if mode == "comb" and comb.PACKED:
            raise RuntimeError("the comb mode reads dense rows; packed rows "
                               "(use_row_packing) only feed the fused path")
        self.device = resolve_device(device)
        if mesh is None:
            mesh = Mesh([self.device])  # one device: a mesh of one
        if mesh.size & (mesh.size - 1):
            # batches pad to power-of-two buckets, which a mesh of another
            # size cannot divide evenly
            raise ValueError(
                f"GpuVerifier needs a power-of-two mesh size, got "
                f"{mesh.size} devices"
            )
        if mesh.devices[0].type != self.device.type:
            raise ValueError(f"device {self.device} and the mesh's "
                             f"{mesh.devices[0]} differ in type")
        self._mesh = mesh
        self.device = mesh.devices[0]
        # pbftlint: disable=PBL006 -- parallel/mesh.shard_map is a torch helper that splits arguments over a Mesh of torch devices and calls the function on each shard; it builds no jit program, so there is no unwarmed dispatch surface to guard
        self._mesh_fn = shard_map(self._shard_pass, mesh,
                                  _mesh_specs(mode, mesh.axis_names[0]))
        self._mode = mode
        self._window = window
        # initial_keys sizes the bank for the EXPECTED key population
        # (committee + clients), so the table never has to be regrown
        # and re-uploaded under live traffic.
        cap = 8
        if initial_keys is not None:
            cap = 1 << max(3, int(initial_keys - 1).bit_length())
        self._bank = (
            KeyBank(initial_capacity=cap, device=self.device, mode=mode, window=window)
            if mode in ("comb", "fused")
            else None
        )
        self.config = (comb.config_name(mode, window, self._bank.row)
                       if self._bank is not None else mode)
        self._cpu_fb = None  # lazy batched native verifier (over-cap keys)
        # Device-side accounting, owned by the verifier: seconds are
        # dispatch->result time of each pass, measured by the caller that
        # enqueued it. Monotonic (read-only) counters.
        self.device_calls = 0
        self.device_items = 0
        self.device_seconds = 0.0
        # Shape accounting: a (mode, window, bucket, table capacity) tuple
        # never dispatched before is a first-time shape (a fresh allocation
        # pattern); after warmup declared the shape set closed it counts
        # in post_warm_compiles, which must stay 0.
        self.shape_signatures: set = set()
        self.shape_compiles = 0
        self.post_warm_compiles = 0
        self.bucket_hits: Dict[int, int] = {}
        self._warm_done = False
        self._launches_at_warm = _kernel_launches()
        # chunks dispatched (counted under the device lock, beside their
        # launches), and after the warm the largest dispatch_batch call
        # and the calls split into more than one chunk of BUCKETS[-1]
        self._chunks = 0
        self._chunks_at_warm = 0
        self.max_dispatch_items = 0
        self.chunked_dispatches = 0

    @classmethod
    def for_population(
        cls,
        pubkeys: Sequence[bytes],
        max_sweep: int,
        headroom: int = 32,
        **kwargs,
    ) -> "GpuVerifier":
        """Build + warm a verifier for a known deployment in one step:
        size the bank to the published key population (+headroom for
        walk-in client keys) and run every batch bucket a drain sweep of
        up to `max_sweep` items can hit."""
        v = cls(initial_keys=len(pubkeys) + headroom, **kwargs)
        v.warm_for_population(pubkeys, max_sweep)
        return v

    def warm_for_population(
        self, pubkeys: Sequence[bytes], max_sweep: int
    ) -> None:
        """Register the key population and warm every batch bucket up to
        the one covering `max_sweep` items. Logs when the population
        exceeds the bank budget — over-cap keys verify on the per-batch
        CPU path forever."""
        if self._bank is not None and len(pubkeys) > self._bank._max_keys:
            log.warning(
                "GpuVerifier bank clamped: %d published keys > max_keys=%d "
                "(%s); over-cap keys verify on the CPU fallback path",
                len(pubkeys), self._bank._max_keys, self.config,
            )
        top = _bucket_size(max(1, min(max_sweep, BUCKETS[-1])))
        self.warm(pubkeys=pubkeys, buckets=[b for b in BUCKETS if b <= top])
        self._warm_done = True
        with _DEVICE_LOCK:
            self._launches_at_warm = _kernel_launches()
            self._chunks_at_warm = self._chunks

    def warm(
        self,
        pubkeys: Sequence[bytes] = (),
        buckets: Sequence[int] = (8,),
    ) -> None:
        """Register the known key population, then run one throwaway
        device pass per batch bucket (this builds the CUDA kernel on
        first use and primes the allocator at the final table shape)."""
        if self._bank is not None:
            for pk in pubkeys:
                self._bank.lookup(pk)
        # wrong-length pubkey: _split_items masks the row and the bank
        # rejects it without registering — an all-zero 32-byte key would
        # decompress to a valid (order-4) point and occupy a bank slot
        dummy = BatchItem(bytes(31), b"", bytes(64))
        for b in buckets:
            self.verify_batch([dummy] * b)

    def _record_shape(self, size: int) -> bool:
        """Track the (bucket, capacity) shape this dispatch hits; returns
        whether it is first-time (the device ledger's compile column)."""
        cap = self._bank._cap if self._bank is not None else 0
        sig = (self._mode, self._window, size, cap)
        self.bucket_hits[size] = self.bucket_hits.get(size, 0) + 1
        fresh = sig not in self.shape_signatures
        if fresh:
            self.shape_signatures.add(sig)
            self.shape_compiles += 1
            if self._warm_done:
                self.post_warm_compiles += 1
                log.warning(
                    "GpuVerifier: first-time shape %s AFTER warmup "
                    "(extend warm_for_population's bucket set or "
                    "initial_keys)", sig,
                )
        return fresh

    def shape_snapshot(self) -> dict:
        """Shape-stability counters for the telemetry plane, and each
        CUDA kernel's launches in this process since the warm ended."""
        return {
            "config": self.config,
            "warmed": self._warm_done,
            "shape_compiles": self.shape_compiles,
            "post_warm_compiles": self.post_warm_compiles,
            "bucket_hits": {str(k): v for k, v in sorted(self.bucket_hits.items())},
            "kernel_launches_after_warm": {
                k: v - self._launches_at_warm[k]
                for k, v in _kernel_launches().items()
            },
        }

    def launch_tally(self) -> dict:
        """The chunks dispatched since the warm ended and each CUDA
        kernel's launches since then, read together under the device lock:
        a chunk enqueues its launches and counts itself inside that lock,
        so the two agree even while passes are in flight. Also the largest
        dispatch after the warm and how many were split into chunks."""
        with _DEVICE_LOCK:
            return {
                "chunks": self._chunks - self._chunks_at_warm,
                "launches": {k: v - self._launches_at_warm[k]
                             for k, v in _kernel_launches().items()},
                "max_dispatch_items": self.max_dispatch_items,
                "chunked_dispatches": self.chunked_dispatches,
            }

    def verify_batch(self, items: Sequence[BatchItem]) -> List[bool]:
        return self.dispatch_batch(items)()

    def dispatch_batch(self, items: Sequence[BatchItem]):
        """Host-prep + ASYNC device dispatch; returns a zero-arg finisher
        that blocks on the device result and maps verdicts back per item.
        CUDA work is asynchronous, so the device executes this batch
        while the caller preps and dispatches the next one."""
        if not items:
            return lambda: []
        from .. import devledger

        finishers = []
        maxb = BUCKETS[-1]
        if self._warm_done:
            self.max_dispatch_items = max(self.max_dispatch_items, len(items))
            if len(items) > maxb:
                self.chunked_dispatches += 1
        # the dispatcher's queue-wait annotation covers the WHOLE take:
        # consume it once here and attribute it to the first chunk
        annotation = devledger.take_annotation()
        for start in range(0, len(items), maxb):
            chunk = items[start : start + maxb]
            finishers.append(self._dispatch_chunk(chunk, annotation))
            annotation = (0.0, 0)

        def finish() -> List[bool]:
            out: List[bool] = []
            for fin in finishers:
                out.extend(fin())
            return out

        return finish

    def prepare(self, items: Sequence[BatchItem]):
        """The mode's host staging: (WireBatch, CombBatch or PreparedBatch,
        fallback). The ladder mode has no fallback: the device verifies
        every key."""
        if self._mode == "ladder":
            return prepare_batch(items), []
        prepare = prepare_wire_batch if self._mode == "fused" else prepare_comb_batch
        return prepare(items, self._bank)

    def _shard_pass(self, *args) -> torch.Tensor:
        """One shard's device pass: its staged arrays, then its tables."""
        return self.device_pass(list(args[:-1]), args[-1])

    def mesh_pass(self, arrays) -> List[torch.Tensor]:
        """The mode's pass over the mesh on a staged batch's host arrays
        (the batch a multiple of the mesh size) -> one (B/k,) bool verdict
        tensor a shard, on its device, in mesh order."""
        tables = [None if self._bank is None else self._bank.device_tables(d)
                  for d in self._mesh.devices]
        return self._mesh_fn(*arrays, tables)

    def device_pass(self, arrays: List[torch.Tensor],
                    tables: Optional[torch.Tensor]) -> torch.Tensor:
        """The mode's device pass on the staged batch's tensors (a
        WireBatch's in fused mode, a CombBatch's in comb mode, a
        PreparedBatch's in ladder mode) and the bank's tables (None in
        ladder mode), all on one device -> (B,) bool."""
        if self._mode == "ladder":
            return verify_kernel(*arrays)
        if self._mode == "fused":
            wire, a_idx, precheck = arrays
            return comb.fused_verify_wire_kernel(wire, a_idx, tables, precheck,
                                                 window=1 << self._window)
        s_nib, k_nib, a_idx, r_y, r_sign, precheck = arrays
        return comb.comb_verify_kernel(s_nib, k_nib, a_idx, tables,
                                       comb.base_table_device(tables.device), r_y, r_sign,
                                       precheck)

    def _dispatch_chunk(
        self,
        items: Sequence[BatchItem],
        annotation: "tuple[float, int]" = (0.0, 1),
    ):
        from .. import devledger, spans

        t_prep = time.perf_counter()
        size = _bucket_size(max(len(items), self._mesh.size))
        prep, fallback = self.prepare(items)
        prep = prep.padded(size)
        arrays = prep.arrays()
        compile_fresh = self._record_shape(size)
        prep_s = time.perf_counter() - t_prep
        spans.record(spans.VERIFY_HOST_PREP, prep_s, n=len(items))
        bytes_up = sum(a.nbytes for a in arrays)
        queue_wait_s, submissions = annotation
        with _DEVICE_LOCK:
            t0 = time.perf_counter()
            dev_out = self.mesh_pass(arrays)  # CUDA: enqueue only
            self._chunks += 1
            self.device_calls += 1
            self.device_items += len(items)

        def finish() -> List[bool]:
            # copy to the host blocks until the device answers; the shards'
            # verdicts join in mesh order into a writable array, whose
            # fallback rows below are set in place
            verdict = gather(dev_out)
            rtt = time.perf_counter() - t0
            with _DEVICE_LOCK:
                self.device_seconds += rtt
            devledger.record(
                devledger.LANE_ED25519, self._mode, self._window, size,
                len(items), host_prep_s=prep_s, rtt_s=rtt,
                compile_fresh=compile_fresh, bytes_up=bytes_up,
                bytes_down=size, queue_wait_s=queue_wait_s,
                submissions=submissions,
            )
            if fallback:
                if self._cpu_fb is None:
                    from .verifier import kernel_equivalent_cpu_verifier

                    # kernel-EQUIVALENT only (native batched Ed25519, else
                    # the RFC 8032 oracle — never OpenSSL): the fallback
                    # rows share a verdict bitmap with kernel rows, so the
                    # two accept/reject sets must agree on every edge
                    # vector or a crafted signature splits the pile
                    self._cpu_fb = kernel_equivalent_cpu_verifier()
                # keys over the bank cap: ONE batched native-CPU pass
                fb_out = self._cpu_fb.verify_batch(
                    [items[i] for i in fallback]
                )
                for i, ok_i in zip(fallback, fb_out):
                    verdict[i] = ok_i
            return verdict[: prep.n].tolist()

        return finish
