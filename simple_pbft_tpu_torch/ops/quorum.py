"""The quorum tally of a shard: its kernel, the plain version, and the
dispatcher the quorum steps call.

The counterpart of the tally inside the JAX package's quorum steps,
``parallel/sharded_verify.py`` `make_comb_quorum_step` and
`make_quorum_step`: ``jnp.sum(onehot * verdict[:, None].astype(int32),
axis=0)``. On a CUDA tensor `quorum_tally` launches the hand-written kernel
``csrc/quorum_tally.cu`` (`tally_kernel`, built with nvcc at first use);
on a CPU tensor it runs `quorum_tally_plain`. Both are exact integer sums.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .comb import _CSRC, _P, _CudaKernel, _check_cuda, _check_dtype


def _check_shapes(onehot: torch.Tensor, verdict: torch.Tensor) -> None:
    if onehot.dim() != 2 or verdict.shape != (onehot.shape[0],) or onehot.numel() == 0:
        raise ValueError(f"shapes (B, n_inst), (B,) with B, n_inst > 0 required, got "
                         f"{tuple(onehot.shape)}, {tuple(verdict.shape)}")


class QuorumTallyKernel(_CudaKernel):
    """Wrapper of the quorum tally kernel (csrc/quorum_tally.cu): onehot
    (B, n_inst) int32 and verdict (B,) bool -> counts (n_inst,) int32.

    ``launches_by`` counts launches under "quorum_tally"."""

    SOURCE = os.path.join(_CSRC, "quorum_tally.cu")
    LIB_NAME = "libquorum_tally.so"

    def _bind(self, lib: ctypes.CDLL) -> None:
        lib.quorum_tally_launch.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_int, _P]
        lib.quorum_tally_launch.restype = ctypes.c_int

    def __call__(self, onehot: torch.Tensor, verdict: torch.Tensor) -> torch.Tensor:
        dev = _check_cuda(onehot, verdict)
        _check_dtype(onehot, torch.int32, "onehot")
        _check_dtype(verdict, torch.bool, "verdict")
        _check_shapes(onehot, verdict)
        batch, n_inst = onehot.shape
        lib = self.library()
        counts = torch.empty((n_inst,), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.quorum_tally_launch(onehot.data_ptr(), verdict.data_ptr(),
                                         counts.data_ptr(), batch, n_inst,
                                         torch.cuda.current_stream(dev).cuda_stream)
        self._raise_on(rc, "quorum_tally")
        self._count("quorum_tally")
        return counts


tally_kernel = QuorumTallyKernel()


def quorum_tally_plain(onehot: torch.Tensor, verdict: torch.Tensor) -> torch.Tensor:
    """The JAX expression in PyTorch: (B, n_inst) int32, (B,) bool ->
    (n_inst,) int32, wrapping modulo 2^32 as an int32 sum does."""
    _check_shapes(onehot, verdict)
    return (onehot.long() * verdict.long()[:, None]).sum(0).to(torch.int32)


def quorum_tally(onehot: torch.Tensor, verdict: torch.Tensor) -> torch.Tensor:
    """A shard's tally: a CUDA tensor launches the kernel (one launch), a
    CPU tensor runs `quorum_tally_plain`. There is no other route."""
    if verdict.device.type == "cuda":
        return tally_kernel(onehot.contiguous(), verdict.contiguous())
    if verdict.device.type == "cpu":
        return quorum_tally_plain(onehot, verdict)
    raise ValueError(f"quorum_tally runs on cuda or cpu, not {verdict.device}")
