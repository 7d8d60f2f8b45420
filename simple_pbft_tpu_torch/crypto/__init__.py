"""Crypto plane: Ed25519 signing/verification with pluggable backends.

The reference has *no* signature cryptography (grep over the reference:
only SHA-256 in utils/utils.go:13-17); its author's gap list
(需要改进的地方.md:17) calls for per-node keys and signed consensus messages.
This package supplies that, TPU-first:

- ``ed25519_cpu``: pure-Python RFC 8032 implementation — signing, and the
  known-answer verification oracle.
- ``gpu_verifier``: batched verification in PyTorch on a CUDA device —
  limb-decomposed GF(2^255-19) arithmetic (``..ops``), fused comb-table
  double-scalar multiplication, verdict bitmaps, bucketed batching,
  key-table bank.
- ``signer``: per-node signing identity used by every outbound message.
- ``verifier``: the pluggable ``Verifier`` seam the consensus plane drains
  batches into (the seam sits where the reference's prepared()/committed()
  quorum predicates live, pbft_impl.go:207-232).
"""

from .verifier import BatchItem, CpuVerifier, Verifier  # noqa: F401
