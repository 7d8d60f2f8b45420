"""The pluggable ``Verifier`` seam between consensus and crypto backends.

This is the north-star interface from BASELINE.json: the consensus plane
drains every pending (message-bytes, signature, pubkey) tuple from its pools
into ``verify_batch`` and gets back a validity bitmap, so quorum-certificate
formation costs one backend call per round. The seam sits exactly where the
reference's ``prepared()``/``committed()`` quorum predicates would have
verified votes inline (pbft_impl.go:207-232) had it had signatures.

Backends:
- ``CpuVerifier`` — pure-Python RFC 8032 (reference-equivalent behavior,
  known-answer oracle).
- ``GpuVerifier`` (crypto/gpu_verifier.py) — batches onto a CUDA device
  via the PyTorch Ed25519 pipeline, padding to bucketed batch shapes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Protocol, Sequence

from . import ed25519_cpu


@dataclass(frozen=True)
class BatchItem:
    """One pending signature check: (pubkey, message bytes, signature)."""

    pubkey: bytes  # 32-byte compressed Ed25519 public key
    msg: bytes  # the signed payload (canonical message encoding)
    sig: bytes  # 64-byte signature (R || S)


class Verifier(Protocol):
    """Backend interface: batch in, bitmap out. Must be order-preserving."""

    def verify_batch(self, items: Sequence[BatchItem]) -> List[bool]:
        ...


class CpuVerifier:
    """Reference-equivalent CPU backend (pure-Python RFC 8032)."""

    name = "cpu"

    def verify_batch(self, items: Sequence[BatchItem]) -> List[bool]:
        return ed25519_cpu.batch_verify_cpu(
            [it.pubkey for it in items],
            [it.msg for it in items],
            [it.sig for it in items],
        )


class OpenSSLVerifier:
    """Fast CPU backend via the `cryptography` wheel (OpenSSL), when
    present. This is the honest CPU baseline the TPU backend competes
    with — pure-Python verification would flatter the TPU numbers."""

    name = "openssl"

    MAX_KEYS = 8192  # parsed-key cache bound: an adversarial client
    # spraying fresh valid curve points must not grow host memory
    # without bound (same rationale as NativeEdVerifier.MAX_KEYS; this
    # verifier also sees exactly that traffic shape as a CPU fallback).
    # At cap the cache STOPS INSERTING rather than clearing (ADVICE r5):
    # committee keys land early and stay resident, so adversarial
    # fresh-key churn costs the ATTACKER's items a parse each, never a
    # committee-wide cold restart — mirroring NativeEdVerifier._row_for.

    def __init__(self) -> None:
        from cryptography.hazmat.primitives.asymmetric.ed25519 import (
            Ed25519PublicKey,
        )

        self._load = Ed25519PublicKey.from_public_bytes
        self._cache: dict = {}

    def verify_batch(self, items: Sequence[BatchItem]) -> List[bool]:
        out = []
        for it in items:
            # any failure (bad point encoding, bad sig, wrong length) is
            # simply an invalid item — a bitmap False, never an exception
            try:
                pk = self._cache.get(it.pubkey)
                if pk is None:
                    pk = self._load(it.pubkey)
                    if len(self._cache) < self.MAX_KEYS:
                        self._cache[it.pubkey] = pk
                pk.verify(it.sig, it.msg)
                out.append(True)
            except Exception:
                out.append(False)
        return out


import threading as _threading

# shared across NativeEdVerifier instances (see its __init__)
_ROW_CACHE_LOCK = _threading.Lock()
_ROW_CACHE: dict = {}


class NativeEdVerifier:
    """Batched C++ backend (native/ed25519.cpp): the host decompresses
    each committee pubkey ONCE (exact bigint math, cached), challenge
    scalars come from the native SHA-512 batch, and the library evaluates
    [S]B + [k](-A) per item with one field inversion for the whole batch.
    Same strict semantics as the TPU kernel (ops/comb.py): a non-
    canonical or off-curve R never matches. ~2x the per-core rate of the
    OpenSSL per-item path on batched consensus traffic."""

    name = "native"

    def __init__(self) -> None:
        import numpy as np

        from .. import native

        if not native.ed25519_available():
            raise ImportError("native ed25519 library unavailable")
        self._native = native
        self._np = np
        # pubkey bytes -> (64,) uint8 affine row x||y | None (bad point).
        # PROCESS-WIDE and bounded: the decompressed row is a pure
        # function of the key bytes, so all in-process replicas share one
        # cache (a simulated n=100 committee otherwise pays 100 cold
        # decompressions per key — measured ~11% of committee CPU in a
        # short bench window). Committee keys land early and stay; once
        # MAX_KEYS distinct keys have been seen (adversarial client-key
        # churn), later keys are decompressed per batch instead of
        # cached, so memory stays O(MAX_KEYS). Locked: the replica
        # pipeline overlaps sweeps' verifies in executor threads.
        self._key_lock = _ROW_CACHE_LOCK
        self._row_cache = _ROW_CACHE

    MAX_KEYS = 8192  # ~0.5 MiB of rows; SIG_CACHE_MAX-style bound

    def _row_for(self, pubkey: bytes):
        """Affine bank row for a pubkey, or None for a bad point."""
        with self._key_lock:
            if pubkey in self._row_cache:
                return self._row_cache[pubkey]
        # decompression (exact bigint math) runs outside the lock; a
        # racing duplicate computation is harmless, the insert re-checks
        pt = (
            ed25519_cpu.point_decompress(pubkey)
            if len(pubkey) == 32
            else None
        )
        if pt is None:
            row = None
        else:
            x, y = ed25519_cpu.point_to_affine(pt)
            row = self._np.frombuffer(
                x.to_bytes(32, "little") + y.to_bytes(32, "little"),
                dtype=self._np.uint8,
            )
        with self._key_lock:
            if len(self._row_cache) < self.MAX_KEYS:
                self._row_cache.setdefault(pubkey, row)
        return row

    def verify_batch(self, items: Sequence[BatchItem]) -> List[bool]:
        np = self._np
        n = len(items)
        if n == 0:
            return []
        key_idx = np.full(n, -1, dtype=np.int32)
        s_sc = np.zeros((n, 32), dtype=np.uint8)
        r_wire = np.zeros((n, 32), dtype=np.uint8)
        a_enc = np.zeros((n, 32), dtype=np.uint8)
        precheck = np.zeros(n, dtype=np.uint8)
        msgs: List[bytes] = []
        # per-batch bank, deduped by pubkey: the library rebuilds w-NAF
        # tables per call, so the cost must scale with the batch's
        # distinct signers, not with every key ever seen
        local_idx: dict = {}
        bank_rows: list = []
        for i, it in enumerate(items):
            msgs.append(it.msg)
            if len(it.sig) != 64 or len(it.pubkey) != 32:
                continue
            s_int = int.from_bytes(it.sig[32:], "little")
            if s_int >= ed25519_cpu.L:  # malleable S: reject (RFC 8032)
                continue
            j = local_idx.get(it.pubkey, -1)  # -1 = first sighting
            if j == -1:
                row = self._row_for(it.pubkey)
                if row is None:
                    local_idx[it.pubkey] = None  # bad point: remember
                    continue
                j = local_idx[it.pubkey] = len(bank_rows)
                bank_rows.append(row)
            elif j is None:  # seen this batch, known-bad point
                continue
            key_idx[i] = j
            s_sc[i] = np.frombuffer(it.sig[32:], dtype=np.uint8)
            r_wire[i] = np.frombuffer(it.sig[:32], dtype=np.uint8)
            a_enc[i] = np.frombuffer(it.pubkey, dtype=np.uint8)
            precheck[i] = 1
        k_sc = self._native.challenge_batch(r_wire, a_enc, msgs)
        bank = (
            np.stack(bank_rows)
            if bank_rows
            else np.zeros((0, 64), dtype=np.uint8)
        )
        out = self._native.ed25519_batch_verify(
            bank, key_idx, s_sc, k_sc, r_wire, precheck
        )
        if out is None:  # library vanished mid-run: degrade honestly
            return CpuVerifier().verify_batch(items)
        return [bool(v) for v in out]


def best_cpu_verifier() -> Verifier:
    try:
        return NativeEdVerifier()
    except ImportError:
        pass
    try:
        return OpenSSLVerifier()
    except ImportError:  # pragma: no cover
        return CpuVerifier()


def kernel_equivalent_cpu_verifier() -> Verifier:
    """Fastest CPU backend whose accept/reject set MATCHES the TPU
    kernel bit-for-bit: NativeEdVerifier, else the RFC 8032 oracle —
    never OpenSSL. The kernel is cofactorless and strict (non-canonical
    or off-curve R never matches; S >= L rejects); OpenSSL's Ed25519
    differs on exactly those edge vectors, so using it where a verdict
    must agree with the kernel (the TpuVerifier's over-bank-cap
    fallback: one BATCH split between kernel and fallback) would let a
    crafted signature verify on some items of a pile and not others —
    a committee-splitting primitive (ADVICE r5)."""
    try:
        return NativeEdVerifier()
    except ImportError:
        return CpuVerifier()


class InsecureVerifier:
    """Accept-everything backend — parity mode with the unsigned reference
    (useful for isolating consensus-plane behavior/benchmarks from crypto)."""

    name = "insecure"

    def verify_batch(self, items: Sequence[BatchItem]) -> List[bool]:
        return [True] * len(items)
