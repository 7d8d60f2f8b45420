"""Message signing for replicas/clients.

Pure-Python RFC 8032 signing (`ed25519_cpu.sign`) is the always-available
reference path, but it costs ~1 ms per signature (bigint scalar mult). When
the host has the `cryptography` wheel (OpenSSL), signing drops to ~20 µs —
that's the difference between a consensus plane that can and cannot feed a
batched device verifier. Both paths produce identical signatures
(Ed25519 signing is deterministic; cross-checked in tests).
"""

from __future__ import annotations

from . import ed25519_cpu

try:  # fast path: OpenSSL via `cryptography`
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
    )

    _HAVE_OPENSSL = True
except ImportError:  # pragma: no cover
    _HAVE_OPENSSL = False


class Signer:
    """Holds one identity's signing key; signs canonical payloads."""

    def __init__(self, node_id: str, seed: bytes) -> None:
        self.node_id = node_id
        self.pub = ed25519_cpu.public_key(seed)
        if _HAVE_OPENSSL:
            self._sk = Ed25519PrivateKey.from_private_bytes(seed)
            self._seed = None
        else:
            self._sk = None
            self._seed = seed

    def sign(self, payload: bytes) -> bytes:
        if self._sk is not None:
            return self._sk.sign(payload)
        return ed25519_cpu.sign(self._seed, payload)

    def sign_msg(self, msg) -> None:
        """Fill in msg.sig (hex) over its signing payload, in place."""
        msg.sender = self.node_id
        msg.sig = self.sign(msg.signing_payload()).hex()
