"""The ladder mode's device pass: K9 and its plain version, in one layer.

The counterpart of the JAX package's ``crypto/tpu_verifier.py``
`verify_kernel` (an XLA program there): per item, A and R decompressed on
the device, the 256-step Straus ladder [S]B + [k](−A) and the projective
comparison with R, on the arrays `crypto/gpu_verifier.prepare_batch`
stages. On a CUDA tensor `verify_kernel` launches the hand-written kernel
``csrc/ladder_verify.cu`` (`ladder_kernel`, built with nvcc at first use);
on a CPU tensor it runs `verify_kernel_plain`, the same formulas in
PyTorch (ops/edwards.py), whose results equal the kernel's after
canonical reduction.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from . import edwards as ed
from . import field25519 as fe
from .comb import _CSRC, _P, _CudaKernel, _check_cuda, _check_dtype


class LadderVerifyKernel(_CudaKernel):
    """Wrapper of the ladder kernel K9 (csrc/ladder_verify.cu): the keyless
    verify of the ladder mode, per lane A's and R's decompression, the
    256-step Straus ladder [S]B + [k](−A) and the projective comparison
    with R, on the JAX package's `prepare_batch` arrays.

    ``launches_by`` counts launches under "ladder_verify"."""

    SOURCE = os.path.join(_CSRC, "ladder_verify.cu")
    LIB_NAME = "libladder_verify.so"
    POINT_OPS = {"double": 0, "add": 1, "decompress": 2}

    def _bind(self, lib: ctypes.CDLL) -> None:
        lib.ladder_verify_launch.argtypes = [_P] * 9 + [ctypes.c_int, _P]
        lib.ladder_verify_launch.restype = ctypes.c_int
        lib.ladder_point_op_launch.argtypes = [ctypes.c_int] + [_P] * 5 + [ctypes.c_int, _P]
        lib.ladder_point_op_launch.restype = ctypes.c_int

    def __call__(self, a_y: torch.Tensor, a_sign: torch.Tensor, r_y: torch.Tensor,
                 r_sign: torch.Tensor, s_bits: torch.Tensor, k_bits: torch.Tensor,
                 precheck: torch.Tensor, affine: bool = False):
        """a_y, r_y (17, B) int32 limbs, a_sign, r_sign (B,) int32, s_bits,
        k_bits (256, B) int32 bits MSB first, precheck (B,) bool -> (B,)
        bool verdicts; with affine=True also the ladder's canonical affine
        (x, y) limbs, (2·17, B) int32."""
        dev = _check_cuda(a_y, a_sign, r_y, r_sign, s_bits, k_bits, precheck)
        for t, what in ((a_y, "a_y"), (a_sign, "a_sign"), (r_y, "r_y"), (r_sign, "r_sign"),
                        (s_bits, "s_bits"), (k_bits, "k_bits")):
            _check_dtype(t, torch.int32, what)
        _check_dtype(precheck, torch.bool, "precheck")
        batch = precheck.shape[0]
        if (precheck.dim() != 1 or batch == 0
                or a_y.shape != (fe.NLIMB, batch) or r_y.shape != (fe.NLIMB, batch)
                or a_sign.shape != (batch,) or r_sign.shape != (batch,)
                or s_bits.shape != (256, batch) or k_bits.shape != (256, batch)):
            shapes = [tuple(t.shape) for t in (a_y, a_sign, r_y, r_sign, s_bits, k_bits,
                                               precheck)]
            raise ValueError(f"shapes (17, B), (B,), (17, B), (B,), (256, B), (256, B), (B,) "
                             f"required, got {shapes}")
        lib = self.library()
        verdict = torch.empty((batch,), dtype=torch.bool, device=dev)
        xy = (torch.empty((2 * fe.NLIMB, batch), dtype=torch.int32, device=dev)
              if affine else None)
        with torch.cuda.device(dev):
            rc = lib.ladder_verify_launch(
                a_y.data_ptr(), a_sign.data_ptr(), r_y.data_ptr(), r_sign.data_ptr(),
                s_bits.data_ptr(), k_bits.data_ptr(), precheck.data_ptr(), verdict.data_ptr(),
                xy.data_ptr() if affine else None, batch,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        self._raise_on(rc, "ladder_verify")
        self._count("ladder_verify")
        return (verdict, xy) if affine else verdict

    def point_op(self, op: str, p: torch.Tensor, q: Optional[torch.Tensor] = None,
                 sign: Optional[torch.Tensor] = None):
        """Test entry for the kernel's point operations on the card, a group
        of threads a point as in K9 (not a launch of the path, so not
        counted): p, q (4·17, n) int32 points in 17×15 limbs, sign (n,)
        int32 -> ((4·17, n) canonical limbs, (n,) bool) of 2p ("double"),
        p + q ("add", q taken in the cached form the ladder's table
        holds) or the decompression of p's Y with `sign` ("decompress",
        with its ok flags; the other ops give True)."""
        q = p if q is None else q
        n = p.shape[-1]
        sign = torch.zeros(n, dtype=torch.int32, device=p.device) if sign is None else sign
        dev = _check_cuda(p, q, sign)
        for t, what in ((p, "p"), (q, "q"), (sign, "sign")):
            _check_dtype(t, torch.int32, what)
        if p.shape != (4 * fe.NLIMB, n) or q.shape != p.shape or sign.shape != (n,) or n == 0:
            raise ValueError(f"(68, n), (68, n), (n,) required, got {tuple(p.shape)}, "
                             f"{tuple(q.shape)}, {tuple(sign.shape)}")
        lib = self.library()
        out = torch.empty_like(p)
        ok = torch.empty((n,), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.ladder_point_op_launch(self.POINT_OPS[op], p.data_ptr(), q.data_ptr(),
                                            sign.data_ptr(), out.data_ptr(), ok.data_ptr(), n,
                                            torch.cuda.current_stream(dev).cuda_stream)
        self._raise_on(rc, "ladder_point_op")
        return out, ok.bool()


ladder_kernel = LadderVerifyKernel()


def verify_kernel_plain(a_y, a_sign, r_y, r_sign, s_bits, k_bits, precheck,
                        affine: bool = False):
    """The plain PyTorch version of K9 and the JAX package's verify_kernel,
    call for call: limb/bit-major arrays in, (B,) bool out; with
    affine=True also the ladder's canonical affine (x, y) limbs, (2·17, B)
    int32, as the kernel's debug output.

    Every row runs the identical fixed ladder; invalid decompressions
    produce garbage points whose verdicts are ANDed away — no branches."""
    a_pt, ok_a = ed.decompress(a_y, a_sign)
    r_pt, ok_r = ed.decompress(r_y, r_sign)
    acc = ed.double_scalar_mul_base(s_bits, k_bits, ed.point_neg(a_pt))
    # acc == R, projectively (R has Z = 1): X*1 == x_R * Z, Y*1 == y_R * Z
    x, y, z = acc[0], acc[1], acc[2]
    eq = fe.eq(x, fe.mul(r_pt[0], z)) & fe.eq(y, fe.mul(r_pt[1], z))
    ok = eq & ok_a & ok_r & precheck
    if not affine:
        return ok
    zinv = fe.invert(z)
    xy = torch.cat([fe.to_canonical(fe.mul(x, zinv)), fe.to_canonical(fe.mul(y, zinv))])
    return ok, xy


def verify_kernel(a_y, a_sign, r_y, r_sign, s_bits, k_bits, precheck) -> torch.Tensor:
    """The ladder mode's device pass on a PreparedBatch's tensors -> (B,)
    bool. A CUDA tensor launches K9 (one launch); a CPU tensor runs
    `verify_kernel_plain`. There is no other route."""
    if precheck.device.type == "cuda":
        return ladder_kernel(a_y.contiguous(), a_sign.contiguous(), r_y.contiguous(),
                                  r_sign.contiguous(), s_bits.contiguous(),
                                  k_bits.contiguous(), precheck.contiguous())
    if precheck.device.type == "cpu":
        return verify_kernel_plain(a_y, a_sign, r_y, r_sign, s_bits, k_bits, precheck)
    raise ValueError(f"verify_kernel runs on cuda or cpu, not {precheck.device}")
