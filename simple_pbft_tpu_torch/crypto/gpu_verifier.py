"""Batched Ed25519 verification on a CUDA device — the port's verify path.

The counterpart of the JAX package's ``crypto/tpu_verifier.py`` in its
shipped default, the fused comb engine with 4-bit windows:

- The consensus plane drains every pending (pubkey, message, signature)
  tuple into one batch.
- Host prep is vectorized: wire bytes are decoded with numpy (one join +
  frombuffer per batch), the challenge scalars k = SHA-512(R||A||M) mod L
  come from the native batch hasher, and the S >= L / R.y >= p prechecks
  are numpy compares. The device receives ~100 raw bytes per item.
- One device pass per batch (ops/comb.fused_verify_wire_kernel): on a
  CUDA device two hand-written kernels, the accumulate kernel in wire
  mode (window extraction, row gather, the 64 mixed adds) and the
  verdict kernel (per-lane inversion, encoding, comparison).
- Batches are padded to bucketed sizes (powers of two), so a device pass
  sees a handful of shapes; the verdict bitmap maps back per item, so
  one bad signature never poisons a quorum.

Verification equation (cofactorless, RFC 8032 permits): [S]B == R + [k]A,
rearranged to [S]B + [k](−A) == R.

The verifier runs on CUDA unless constructed with ``device="cpu"`` (the
tests do); without a CUDA device it raises instead of falling back.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import native, resolve_device
from ..ops import comb
from . import ed25519_cpu as ref
from .verifier import BatchItem

log = logging.getLogger(__name__)

# Bucketed batch sizes: drained pools are padded up to the next bucket.
BUCKETS = (8, 32, 128, 512, 2048, 8192)

WINDOW_BITS = 4  # the fused w=4 comb: 64 positions, 4 MiB per key

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
    """The process's launch counts of the device pass's two kernels."""
    return {"fused_accumulate": comb.accumulate_kernel.launches,
            "encode_verdict": comb.encode_kernel.launches}


def _bucket_size(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


def _table_budget_bytes(device: torch.device) -> int:
    """A quarter of the memory of the device that holds the tables: the
    card's total memory for CUDA, physical host memory for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 4
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 4


class KeyBank:
    """Cache of per-pubkey fused comb tables (the committee's key set).

    PBFT pubkeys are few and endlessly reused, so each is decompressed and
    expanded into dense Niels rows once on the host and kept on the
    verifier's device. The bank's capacity grows in powers of two.

    `max_keys` bounds the bank: a Byzantine sender must not be able to
    grow device memory by spraying fresh valid curve points through the
    Verifier seam. The default is a quarter of the device's memory
    (`_table_budget_bytes`) over the 4 MiB of one key's table. Keys beyond
    the cap report UNCACHED and are verified on the CPU fallback path.
    """

    UNCACHED = -2

    def __init__(
        self,
        initial_capacity: int = 8,
        max_keys: Optional[int] = None,
        device="cuda",
    ):
        self.window = WINDOW_BITS
        self.device = resolve_device(device)
        self._rows_per_key = comb.npos_for(WINDOW_BITS) * (1 << (2 * WINDOW_BITS))
        key_bytes = self._rows_per_key * comb.ROW * 4
        default_max = max(8, _table_budget_bytes(self.device) // key_bytes)
        self._index: Dict[bytes, int] = {}
        self._invalid_cache: set = set()
        self._max_keys = default_max if max_keys is None else max_keys
        # clamp: capacity beyond max_keys would allocate table memory the
        # lookup path refuses to ever use
        self._cap = max(1, min(initial_capacity, self._max_keys))
        self._np = np.zeros((self._cap, self._rows_per_key, comb.ROW), np.int32)
        self._dev: Optional[torch.Tensor] = None
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
    ) -> "KeyBank":
        """A bank holding `rows` ((cap, rows_per_key, 64) int32 fused w=4
        tables) under `index` (pubkey -> row) — exactly a JAX KeyBank's
        ``_np`` and ``_index``, so the two verify the same keys alike."""
        bank = cls(initial_capacity=1, max_keys=max_keys, device=device)
        want = (bank._rows_per_key, comb.ROW)
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
        table = comb.fused_table_np(pt, WINDOW_BITS)
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

    def device_tables(self) -> torch.Tensor:
        """Flat (cap * rows_per_key, ROW) int32 table on the bank's device,
        uploaded again only after the bank changed."""
        with self._lock:
            if self._dirty or self._dev is None:
                self._dev = torch.from_numpy(
                    self._np.reshape(self._cap * self._rows_per_key, comb.ROW)
                ).to(self.device)
                self._dirty = False
            return self._dev


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


# One device pass at a time, process-wide. The replica runtime calls
# verify_batch from worker threads; the lock serializes the enqueue of a
# pass's kernels (a single device executes them in order anyway).
_DEVICE_LOCK = threading.Lock()


class GpuVerifier:
    """The `gpu` backend behind the crypto.Verifier seam: the fused comb
    engine (cached per-pubkey dual-scalar tables, zero doublings, no
    on-device decompression, one madd per nibble position, batch-amortized
    inversion) on a CUDA device.

    Pads drained batches to bucketed sizes, runs one device pass per
    chunk, and returns the per-item bitmap.
    """

    name = "gpu"

    def __init__(self, device="cuda", initial_keys: Optional[int] = None):
        self.device = resolve_device(device)
        self._mode = "fused"
        self._window = WINDOW_BITS
        # initial_keys sizes the bank for the EXPECTED key population
        # (committee + clients), so the table never has to be regrown
        # and re-uploaded under live traffic.
        cap = 8
        if initial_keys is not None:
            cap = 1 << max(3, int(initial_keys - 1).bit_length())
        self._bank = KeyBank(initial_capacity=cap, device=self.device)
        self._cpu_fb = None  # lazy batched native verifier (over-cap keys)
        # Device-side accounting, owned by the verifier: seconds are
        # dispatch->result time of each pass, measured by the caller that
        # enqueued it. Monotonic (read-only) counters.
        self.device_calls = 0
        self.device_items = 0
        self.device_seconds = 0.0
        # Shape accounting: a (bucket, table capacity) pair never
        # dispatched before is a first-time shape (a fresh allocation
        # pattern); after warmup declared the shape set closed it counts
        # in post_warm_compiles, which must stay 0.
        self.shape_signatures: set = set()
        self.shape_compiles = 0
        self.post_warm_compiles = 0
        self.bucket_hits: Dict[int, int] = {}
        self._warm_done = False
        self._launches_at_warm = _kernel_launches()

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
        if len(pubkeys) > self._bank._max_keys:
            log.warning(
                "GpuVerifier bank clamped: %d published keys > max_keys=%d; "
                "over-cap keys verify on the CPU fallback path",
                len(pubkeys), self._bank._max_keys,
            )
        top = _bucket_size(max(1, min(max_sweep, BUCKETS[-1])))
        self.warm(pubkeys=pubkeys, buckets=[b for b in BUCKETS if b <= top])
        self._warm_done = True
        self._launches_at_warm = _kernel_launches()

    def warm(
        self,
        pubkeys: Sequence[bytes] = (),
        buckets: Sequence[int] = (8,),
    ) -> None:
        """Register the known key population, then run one throwaway
        device pass per batch bucket (this builds the CUDA kernel on
        first use and primes the allocator at the final table shape)."""
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
        sig = (self._mode, self._window, size, self._bank._cap)
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
            "warmed": self._warm_done,
            "shape_compiles": self.shape_compiles,
            "post_warm_compiles": self.post_warm_compiles,
            "bucket_hits": {str(k): v for k, v in sorted(self.bucket_hits.items())},
            "kernel_launches_after_warm": {
                k: v - self._launches_at_warm[k]
                for k, v in _kernel_launches().items()
            },
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

    def _dispatch_chunk(
        self,
        items: Sequence[BatchItem],
        annotation: "tuple[float, int]" = (0.0, 1),
    ):
        from .. import devledger, spans

        t_prep = time.perf_counter()
        size = _bucket_size(len(items))
        prep, fallback = prepare_wire_batch(items, self._bank)
        prep = prep.padded(size)
        wire, a_idx, precheck = prep.arrays()
        tables = self._bank.device_tables()
        compile_fresh = self._record_shape(size)
        prep_s = time.perf_counter() - t_prep
        spans.record(spans.VERIFY_HOST_PREP, prep_s, n=len(items))
        bytes_up = wire.nbytes + a_idx.nbytes + precheck.nbytes
        queue_wait_s, submissions = annotation
        dev = self.device
        with _DEVICE_LOCK:
            t0 = time.perf_counter()
            dev_out = comb.fused_verify_wire_kernel(
                torch.from_numpy(wire).to(dev),
                torch.from_numpy(a_idx).to(dev),
                tables,
                torch.from_numpy(precheck).to(dev),
            )  # CUDA: enqueue only
            self.device_calls += 1
            self.device_items += len(items)

        def finish() -> List[bool]:
            # copy to the host blocks until the device answers; the copy
            # is writable, fallback rows below are set in place
            verdict = dev_out.cpu().numpy().copy()
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
