"""The quorum tally of a shard: its kernel, the plain version, and the
dispatcher the quorum steps call.

The counterpart of the tally inside the JAX package's quorum steps,
``parallel/sharded_verify.py`` `make_comb_quorum_step` and
`make_quorum_step`: ``jnp.sum(onehot * verdict[:, None].astype(int32),
axis=0)``. On a CUDA tensor `quorum_tally` launches the hand-written kernel
``csrc/quorum_tally.cu`` (`tally_kernel`, built with nvcc at first use);
on a CPU tensor it runs `quorum_tally_plain`. Both are exact integer sums,
modulo 2^32 as JAX's int32 sum wraps. Given ``out=``, both add into that
vector, which is how every shard of a quorum step on one device adds into
one zeroed counts vector.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from .comb import _CSRC, _P, _CudaKernel, _check_cuda, _check_dtype


def _check_shapes(onehot: torch.Tensor, verdict: torch.Tensor) -> None:
    if onehot.dim() != 2 or verdict.shape != (onehot.shape[0],) or onehot.numel() == 0:
        raise ValueError(f"shapes (B, n_inst), (B,) with B, n_inst > 0 required, got "
                         f"{tuple(onehot.shape)}, {tuple(verdict.shape)}")


def _check_out(out: torch.Tensor, onehot: torch.Tensor) -> None:
    _check_dtype(out, torch.int32, "out")
    if out.shape != (onehot.shape[1],):
        raise ValueError(f"out must be ({onehot.shape[1]},), got {tuple(out.shape)}")


def vector_path(onehot: torch.Tensor) -> bool:
    """Whether the kernel reads `onehot` by 16-byte loads (4 instance
    columns a lane): n_inst % 4 == 0 and a 16-byte aligned base. Otherwise
    it reads one int32 column a lane."""
    return onehot.shape[1] % 4 == 0 and onehot.data_ptr() % 16 == 0


class QuorumTallyKernel(_CudaKernel):
    """Wrapper of the quorum tally kernel (csrc/quorum_tally.cu): onehot
    (B, n_inst) int32 and verdict (B,) bool, added into `out` ((n_inst,)
    int32 on the same device) where given, else into a fresh zeroed
    vector; returns that vector.

    ``launches_by`` counts launches under "quorum_tally"."""

    SOURCE = os.path.join(_CSRC, "quorum_tally.cu")
    LIB_NAME = "libquorum_tally.so"

    def _bind(self, lib: ctypes.CDLL) -> None:
        lib.quorum_tally_launch.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int, _P]
        lib.quorum_tally_launch.restype = ctypes.c_int

    def __call__(self, onehot: torch.Tensor, verdict: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        dev = _check_cuda(onehot, verdict, *(() if out is None else (out,)))
        _check_dtype(onehot, torch.int32, "onehot")
        _check_dtype(verdict, torch.bool, "verdict")
        _check_shapes(onehot, verdict)
        batch, n_inst = onehot.shape
        if out is None:
            out = torch.zeros((n_inst,), dtype=torch.int32, device=dev)
        else:
            _check_out(out, onehot)
        lib = self._lib or self.library()
        # the launch function makes `dev` current for the launch itself, so
        # no device guard here; the raw stream handle skips building a
        # torch.cuda.Stream a call
        rc = lib.quorum_tally_launch(onehot.data_ptr(), verdict.data_ptr(), out.data_ptr(),
                                     batch, n_inst, 4 if vector_path(onehot) else 1,
                                     dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
        self._raise_on(rc, "quorum_tally")
        self._count("quorum_tally")
        return out


tally_kernel = QuorumTallyKernel()


def _sums(onehot: torch.Tensor, verdict: torch.Tensor) -> torch.Tensor:
    _check_shapes(onehot, verdict)
    return (onehot.long() * verdict.long()[:, None]).sum(0)


def quorum_tally_plain(onehot: torch.Tensor, verdict: torch.Tensor) -> torch.Tensor:
    """The JAX expression in PyTorch: (B, n_inst) int32, (B,) bool ->
    (n_inst,) int32, wrapping modulo 2^32 as an int32 sum does."""
    return _sums(onehot, verdict).to(torch.int32)


def quorum_tally(onehot: torch.Tensor, verdict: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A shard's tally, added into `out` where given: a CUDA tensor
    launches the kernel (one launch), a CPU tensor runs the plain version
    (summed in int64 with `out` and cast once, so it wraps as JAX's int32
    adds do). There is no other route."""
    if verdict.device.type == "cuda":
        return tally_kernel(onehot.contiguous(), verdict.contiguous(), out=out)
    if verdict.device.type == "cpu":
        if out is None:
            return quorum_tally_plain(onehot, verdict)
        _check_out(out, onehot)
        if out.device.type != "cpu":
            raise ValueError(f"out must be on the CPU with the one-hot, not {out.device}")
        return out.copy_((out.long() + _sums(onehot, verdict)).to(torch.int32))
    raise ValueError(f"quorum_tally runs on cuda or cpu, not {verdict.device}")
