"""ctypes loader for the native host-prep library (pbft_native.cpp).

The shared object is built on demand with g++ (cached in the package's
gitignored ``_build/`` directory, rebuilt when the source is newer) and loaded via ctypes — no pybind11
dependency. Every entry point has a pure-Python fallback so the framework
works on machines without a toolchain; `available()` reports which path is
active and the bench records it.

API (numpy in, numpy out, zero per-item Python work):
- challenge_batch(r, a, msgs) -> (n, 32) uint8 little-endian scalars
  k_i = SHA-512(R_i || A_i || M_i) mod L   (the Ed25519 challenge)
- sha512_batch(msgs) -> (n, 64) uint8 digests
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

from .. import BUILD_DIR, build_dir

log = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "pbft_native.cpp")
_SO = os.path.join(BUILD_DIR, "_pbft_native.so")
_SRC_BLS = os.path.join(os.path.dirname(__file__), "bls381.cpp")
_SO_BLS = os.path.join(BUILD_DIR, "_bls381.so")
_SRC_ED = os.path.join(os.path.dirname(__file__), "ed25519.cpp")
_SO_ED = os.path.join(BUILD_DIR, "_ed25519.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# own lock: a first-use BLS build (g++, up to ~2 min) must not stall
# Ed25519 host-prep calls on the unrelated library
_bls_lock = threading.Lock()
_bls_lib: Optional[ctypes.CDLL] = None
_bls_tried = False
_ed_lock = threading.Lock()
_ed_lib: Optional[ctypes.CDLL] = None
_ed_tried = False

_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def _build_so(src: str, so: str, extra=()) -> bool:
    # per-process temp name: concurrent builders (multi-process launch,
    # parallel test workers) must never interleave linker output in a
    # shared file; os.replace keeps the final install atomic
    build_dir()
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", *extra, "-shared", "-fPIC", "-o", tmp, src]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        log.warning("native build failed (%s) %s — using Python fallback",
                    e, detail.decode(errors="replace")[:500])
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load_library(src: str, so: str, configure, extra=()) -> Optional[ctypes.CDLL]:
    """Shared build-on-demand loader: rebuild when the source is newer
    (tolerating a missing source by using the cached .so), CDLL-load,
    then run ``configure(lib)`` (argtypes + optional selftest; raise
    AttributeError for stale exports, return None to reject). Any
    failure degrades to the caller's Python fallback."""
    name = os.path.basename(so)
    if not _ensure_built(src, so, extra=extra):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        log.warning("%s load failed: %s — using Python fallback", name, e)
        return None
    try:
        return configure(lib)
    except AttributeError as e:
        # a stale cached .so missing newer exports (e.g. source file
        # absent so no rebuild happened): degrade to the Python path
        log.warning("%s stale/incomplete: %s — Python fallback", name, e)
        return None


def _configure_hostprep(lib):
    lib.challenge_batch.argtypes = [
        _u8p, _u8p, _u8p, _i64p, ctypes.c_int64, _u8p,
    ]
    lib.challenge_batch.restype = None
    lib.sha512_batch.argtypes = [_u8p, _i64p, ctypes.c_int64, _u8p]
    lib.sha512_batch.restype = None
    lib.sc_reduce_batch.argtypes = [_u8p, ctypes.c_int64, _u8p]
    lib.sc_reduce_batch.restype = None
    lib.native_num_threads.argtypes = []
    lib.native_num_threads.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            _lib = _load_library(
                _SRC, _SO, _configure_hostprep, extra=("-fopenmp",)
            )
        return _lib


def _configure_bls(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    lib.bls_verify_one.argtypes = [
        u8p, u8p, i64, u8p, u8p, i64, ctypes.c_int,
    ]
    lib.bls_verify_one.restype = ctypes.c_int
    lib.bls_verify_aggregate.argtypes = [
        u8p, i64, u8p, i64, u8p, u8p, i64,
    ]
    lib.bls_verify_aggregate.restype = ctypes.c_int
    lib.bls_verify_batch_rlc.argtypes = [
        u8p, i64, u8p, _i64p, i64, u8p, u8p, u8p, i64,
    ]
    lib.bls_verify_batch_rlc.restype = ctypes.c_int
    lib.bls_sign.argtypes = [u8p, u8p, i64, u8p, i64, u8p]
    lib.bls_sign.restype = ctypes.c_int
    lib.bls_pubkey.argtypes = [u8p, u8p]
    lib.bls_pubkey.restype = ctypes.c_int
    lib.bls_selftest.argtypes = []
    lib.bls_selftest.restype = ctypes.c_int
    if lib.bls_selftest() != 1:
        log.warning("bls381 selftest FAILED — using Python fallback")
        return None
    return lib


def _load_bls() -> Optional[ctypes.CDLL]:
    global _bls_lib, _bls_tried
    with _bls_lock:
        if not _bls_tried:
            _bls_tried = True
            _bls_lib = _load_library(_SRC_BLS, _SO_BLS, _configure_bls)
        return _bls_lib


def _configure_ed(lib):
    _i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    lib.ed25519_batch_verify.argtypes = [
        _u8p, ctypes.c_int, _i32p, _u8p, _u8p, _u8p, _u8p, _u8p,
        ctypes.c_int,
    ]
    lib.ed25519_batch_verify.restype = ctypes.c_int
    lib.ed25519_fused_table.argtypes = [_u8p, ctypes.c_int, _u8p]
    lib.ed25519_fused_table.restype = ctypes.c_int
    return lib


def _load_ed() -> Optional[ctypes.CDLL]:
    global _ed_lib, _ed_tried
    with _ed_lock:
        if not _ed_tried:
            _ed_tried = True
            _ed_lib = _load_library(_SRC_ED, _SO_ED, _configure_ed)
        return _ed_lib


def ed25519_available() -> bool:
    return _load_ed() is not None


def ed25519_fused_table(
    a_xy: np.ndarray, wbits: int
) -> Optional[np.ndarray]:
    """Affine pubkey (64,) uint8 (x||y LE) -> (npos * 4^wbits, 96) uint8
    affine-Niels field-element bytes for the fused dual-scalar comb
    (KeyBank cold-start fast path); None = library unavailable."""
    lib = _load_ed()
    if lib is None:
        return None
    npos = -(-256 // wbits)
    n = npos * (1 << wbits) ** 2
    out = np.empty((n, 96), dtype=np.uint8)
    rc = lib.ed25519_fused_table(
        np.ascontiguousarray(a_xy, dtype=np.uint8), wbits, out
    )
    return out if rc == 0 else None


def ed25519_batch_verify(
    a_xy: np.ndarray,       # (n_keys, 64) uint8: affine x||y, 32B LE each
    key_idx: np.ndarray,    # (B,) int32 into a_xy (-1 = invalid key)
    s_scalars: np.ndarray,  # (B, 32) uint8, already range-checked < L
    k_scalars: np.ndarray,  # (B, 32) uint8, SHA-512(R||A||M) mod L
    r_wire: np.ndarray,     # (B, 32) uint8, signature R wire bytes
    precheck: np.ndarray,   # (B,) uint8 validity mask
) -> Optional[np.ndarray]:
    """Batched [S]B + [k](-A) == R verification; None = unavailable."""
    lib = _load_ed()
    if lib is None:
        return None
    batch = len(key_idx)
    out = np.zeros(batch, dtype=np.uint8)
    rc = lib.ed25519_batch_verify(
        np.ascontiguousarray(a_xy, dtype=np.uint8),
        len(a_xy),
        np.ascontiguousarray(key_idx, dtype=np.int32),
        np.ascontiguousarray(s_scalars, dtype=np.uint8),
        np.ascontiguousarray(k_scalars, dtype=np.uint8),
        np.ascontiguousarray(r_wire, dtype=np.uint8),
        np.ascontiguousarray(precheck, dtype=np.uint8),
        out,
        batch,
    )
    if rc != 0:
        return None
    return out


def _cbuf(b: bytes):
    return (ctypes.c_uint8 * max(1, len(b))).from_buffer_copy(b or b"\0")


def bls_available() -> bool:
    return _load_bls() is not None


def bls_verify_one(
    pubkey: bytes, msg: bytes, sig: bytes, dst: bytes, check_pk: bool
) -> Optional[bool]:
    """Native single-signature BLS verify; None = library unavailable
    (caller falls back to the Python path)."""
    if len(pubkey) != 192 or len(sig) != 96:
        return False
    lib = _load_bls()
    if lib is None:
        return None
    r = lib.bls_verify_one(
        _cbuf(pubkey), _cbuf(msg), len(msg), _cbuf(sig), _cbuf(dst),
        len(dst), 1 if check_pk else 0,
    )
    return bool(r)


def bls_sign(sk: int, msg: bytes, dst: bytes) -> Optional[bytes]:
    """Native BLS sign (bit-identical to the Python path — deterministic
    hash-and-multiply); None = unavailable (caller falls back, including
    out-of-range scalars the bigint path accepts)."""
    if not 0 <= sk < (1 << 256):
        return None
    lib = _load_bls()
    if lib is None:
        return None
    out = (ctypes.c_uint8 * 96)()
    r = lib.bls_sign(
        _cbuf(sk.to_bytes(32, "big")), _cbuf(msg), len(msg), _cbuf(dst),
        len(dst), out,
    )
    return bytes(out) if r else None


def bls_pubkey(sk: int) -> Optional[bytes]:
    """Native G2 pubkey derivation; None = unavailable (caller falls
    back, including out-of-range scalars)."""
    if not 0 <= sk < (1 << 256):
        return None
    lib = _load_bls()
    if lib is None:
        return None
    out = (ctypes.c_uint8 * 192)()
    r = lib.bls_pubkey(_cbuf(sk.to_bytes(32, "big")), out)
    return bytes(out) if r else None


def bls_verify_aggregate(
    pubkeys: Sequence[bytes], msg: bytes, sig: bytes, dst: bytes
) -> Optional[bool]:
    """Native aggregate BLS verify; None = library unavailable."""
    if not pubkeys or len(sig) != 96 or any(len(p) != 192 for p in pubkeys):
        return False
    lib = _load_bls()
    if lib is None:
        return None
    cat = b"".join(pubkeys)
    r = lib.bls_verify_aggregate(
        _cbuf(cat), len(pubkeys), _cbuf(msg), len(msg), _cbuf(sig),
        _cbuf(dst), len(dst),
    )
    return bool(r)


def bls_verify_batch_rlc(
    pubkeys: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    rands: Sequence[int],
    dst: bytes,
) -> Optional[bool]:
    """Native random-linear-combination batch verify of k aggregate
    signatures sharing ONE signer set (the QC-plane fast path): checks
    e(sum r_i*sig_i, G2) == e(sum r_i*H(m_i), agg_pk) with two Miller
    loops total. True = every cert in the batch is valid; False = the
    batch fails (the caller bisects); None = library unavailable."""
    k = len(msgs)
    if (
        k == 0
        or len(sigs) != k
        or len(rands) != k
        or not pubkeys
        or any(len(p) != 192 for p in pubkeys)
        or any(len(s) != 96 for s in sigs)
        or any(not 0 < r < (1 << 256) for r in rands)
    ):
        return False
    lib = _load_bls()
    if lib is None:
        return None
    cat_msgs, offs = b"".join(msgs), np.zeros(k + 1, dtype=np.int64)
    np.cumsum([len(m) for m in msgs], out=offs[1:])
    r = lib.bls_verify_batch_rlc(
        _cbuf(b"".join(pubkeys)), len(pubkeys),
        _cbuf(cat_msgs), np.ascontiguousarray(offs), k,
        _cbuf(b"".join(sigs)),
        _cbuf(b"".join(ri.to_bytes(32, "big") for ri in rands)),
        _cbuf(dst), len(dst),
    )
    return bool(r)


def available() -> bool:
    return _load() is not None


def num_threads() -> int:
    lib = _load()
    return lib.native_num_threads() if lib is not None else 1


def _concat_offsets(msgs: Sequence[bytes]):
    offs = np.zeros(len(msgs) + 1, dtype=np.int64)
    np.cumsum([len(m) for m in msgs], out=offs[1:])
    cat = b"".join(msgs)
    buf = np.frombuffer(cat, dtype=np.uint8) if cat else np.zeros(1, np.uint8)
    return np.ascontiguousarray(buf), offs


def challenge_batch(
    r: np.ndarray, a: np.ndarray, msgs: Sequence[bytes]
) -> np.ndarray:
    """(n, 32) R encodings, (n, 32) A encodings, n message byte strings ->
    (n, 32) uint8 little-endian challenge scalars (mod L, canonical)."""
    n = len(msgs)
    assert r.shape == (n, 32) and a.shape == (n, 32), (r.shape, a.shape)
    out = np.empty((n, 32), dtype=np.uint8)
    if n == 0:
        return out
    lib = _load()
    if lib is not None:
        cat, offs = _concat_offsets(msgs)
        lib.challenge_batch(
            np.ascontiguousarray(r), np.ascontiguousarray(a),
            cat, offs, n, out,
        )
        return out
    from ..crypto import ed25519_cpu as ref  # fallback: per-item Python

    for i, m in enumerate(msgs):
        k = ref.challenge_scalar(r[i].tobytes(), a[i].tobytes(), m)
        out[i] = np.frombuffer(k.to_bytes(32, "little"), np.uint8)
    return out


def sc_reduce_batch(digests: np.ndarray) -> np.ndarray:
    """(n, 64) uint8 little-endian 512-bit values -> (n, 32) uint8
    canonical scalars mod L (the Ed25519 group order)."""
    n = len(digests)
    assert digests.shape == (n, 64), digests.shape
    out = np.empty((n, 32), dtype=np.uint8)
    if n == 0:
        return out
    lib = _load()
    if lib is not None:
        lib.sc_reduce_batch(np.ascontiguousarray(digests), n, out)
        return out
    from ..crypto import ed25519_cpu as ref  # fallback: per-item Python

    for i in range(n):
        v = int.from_bytes(digests[i].tobytes(), "little") % ref.L
        out[i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    return out


def sha512_batch(msgs: Sequence[bytes]) -> np.ndarray:
    """n message byte strings -> (n, 64) uint8 SHA-512 digests."""
    n = len(msgs)
    out = np.empty((n, 64), dtype=np.uint8)
    if n == 0:
        return out
    lib = _load()
    if lib is not None:
        cat, offs = _concat_offsets(msgs)
        lib.sha512_batch(cat, offs, n, out)
        return out
    import hashlib

    for i, m in enumerate(msgs):
        out[i] = np.frombuffer(hashlib.sha512(m).digest(), np.uint8)
    return out


# ---------------------------------------------------------------------------
# canonical-JSON encoder (CPython extension module, canonjson.cpp)
# ---------------------------------------------------------------------------

_SRC_CANON = os.path.join(os.path.dirname(__file__), "canonjson.cpp")
_SO_CANON = os.path.join(BUILD_DIR, "_canonjson.so")
_canon_lock = threading.Lock()
_canon_mod = None
_canon_tried = False


def _python_includes():
    import sysconfig

    return [f"-I{sysconfig.get_path('include')}"]


def _ensure_built(src: str, so: str, extra=()) -> bool:
    """Shared freshness check + build-on-demand (used by the ctypes
    loader below and the extension loader): rebuild when the source is
    newer, tolerate a missing source by trusting the cached .so."""
    try:
        fresh = os.path.exists(so) and (
            os.path.getmtime(so) >= os.path.getmtime(src)
        )
    except OSError:  # source missing: use the existing .so as-is
        fresh = os.path.exists(so)
    return fresh or _build_so(src, so, extra=extra)


def _load_canonjson():
    """Build (on demand) and import the _canonjson extension; None on any
    failure — callers keep the pure-json path. Unlike the ctypes
    libraries this is a real CPython extension (it walks Python objects),
    so it is imported via ExtensionFileLoader, not CDLL."""
    global _canon_mod, _canon_tried
    if _canon_tried:  # lock-free fast path: _canon_mod is write-once
        return _canon_mod
    with _canon_lock:
        if _canon_tried:
            return _canon_mod
        _canon_tried = True  # every exit below is final (no per-call retry)
        if not _ensure_built(_SRC_CANON, _SO_CANON, extra=_python_includes()):
            return None
        try:
            import importlib.machinery
            import importlib.util

            loader = importlib.machinery.ExtensionFileLoader(
                "_canonjson", _SO_CANON
            )
            spec = importlib.util.spec_from_loader("_canonjson", loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
        except (ImportError, OSError) as e:
            log.warning("canonjson load failed: %s — json fallback", e)
            return None
        # self-test: byte-exact equivalence on a representative sample; a
        # silently divergent encoder would FORK the committee (digests),
        # so any mismatch rejects the library outright
        import json as _json

        samples = [
            {"kind": "commit", "seq": 1, "view": 0, "digest": "ab" * 32,
             "sig": "", "b": [1, 2, [3]], "n": None, "t": True},
            {"z": "\x00\x1f\"\\\né€\U0001f600", "a": -(2**80)},
            {"": {"nested": ["\ud800", 2**63 - 1, -(2**63)]}},
        ]
        for s in samples:
            want = _json.dumps(s, sort_keys=True, separators=(",", ":")).encode(
                "utf-8", "surrogatepass"
            )
            if mod.encode(s) != want:
                log.warning("canonjson self-test mismatch — json fallback")
                return None
        _canon_mod = mod
        return mod


def canonjson_encode(obj):
    """Native canonical encode, or None when the library is unavailable
    or the object leaves the wire subset (caller falls back to json)."""
    mod = _load_canonjson()
    if mod is None:
        return None
    try:
        return mod.encode(obj)
    except (TypeError, RecursionError):
        return None


def canonjson_available() -> bool:
    return _load_canonjson() is not None
