"""Sharded batch verify + quorum-certificate counting over a device mesh.

The counterpart of the JAX package's ``parallel/sharded_verify.py``, with
the same names and signatures apart from taking the port's `Mesh`
(parallel/mesh.py). A quorum step

  1. splits the drained vote batch over the mesh along the batch axis and
     verifies each shard on its device (the comb engine: the accumulate
     kernel in comb mode and the verdict kernel's limb entry; or the
     ladder kernel K9), and
  2. tallies each shard's valid votes per consensus instance (the tally
     kernel, csrc/quorum_tally.cu), every shard adding into one zeroed
     counts vector of its device, and sums those vectors over the mesh's
     distinct devices (`psum`), so every device holds the quorum counts.
     k shards on one card are one zeroing and k tally launches, with no
     add between them.

What a step returns follows JAX's ``out_specs=(vec, repl)``: the verdicts
stay one (B/k,) bool tensor a shard, on that shard's device, and the
counts are replicated, one (n_inst,) int32 tensor a position. `gather`
(parallel/mesh.py) concatenates the shards on the host.

The batch axis is the only split one, and the tally's (n_inst,) vector
is the only traffic between devices. The batch must divide over the mesh,
as shard_map requires; pad it first. On CPU tensors every launch is its
plain version.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import devledger
from ..ops import comb
from ..ops.ladder import verify_kernel
from ..ops.quorum import quorum_tally
from .mesh import Mesh, P, psum, shard_map


def _synchronize(mesh) -> None:
    """Wait for every CUDA device of the mesh (the counterpart of
    ``jax.block_until_ready``); CPU work is already done."""
    for d in dict.fromkeys(mesh.devices.flat):
        if isinstance(d, torch.device) and d.type == "cuda":
            torch.cuda.synchronize(d)


def instrument_step(step, mesh: Mesh, mode: str = "ladder",
                    window: int = 4):
    """Wrap a quorum step so every invocation lands in the device ledger as
    PER-DEVICE shard events: mode, bucket (the per-shard batch), pad,
    RTT, first-time shape, host->device bytes.

    The wrapper waits for the mesh's devices, so the recorded RTT is
    dispatch->answer, like ``GpuVerifier``'s. ``n_valid`` is the
    pre-padding item count (pad waste); it defaults to the full batch.
    Recording is per device because every device runs for the whole pass:
    occupancy aggregates correctly only when busy seconds are attributed
    per device.
    """
    ndev = int(np.prod(mesh.devices.shape))
    seen_shapes: set = set()

    def run(*args, n_valid: Optional[int] = None):
        batch = next(
            (int(a.shape[-1]) for a in args
             if hasattr(a, "shape") and len(a.shape) == 1),
            0,
        )
        if batch == 0:  # no 1-D batch arg: run unrecorded, never raise
            return step(*args)
        bytes_up = sum(
            a.nbytes for a in args if isinstance(a, np.ndarray)
        )
        sig = (mode, window, batch)
        fresh = sig not in seen_shapes
        seen_shapes.add(sig)
        t0 = time.perf_counter()
        out = step(*args)
        _synchronize(mesh)
        rtt = time.perf_counter() - t0
        valid = batch if n_valid is None else int(n_valid)
        per = batch // ndev
        per_valid = valid // ndev
        rem = valid - per_valid * ndev
        for d in range(ndev):
            devledger.record(
                devledger.LANE_SHARD, mode, window, per,
                per_valid + (1 if d < rem else 0),
                # one step is one first-time shape, not ndev: stamp it on
                # the first device row only so the lane's compile counter
                # counts shapes
                rtt_s=rtt, compile_fresh=fresh and d == 0,
                bytes_up=bytes_up // ndev, bytes_down=per,
                device=f"d{d}",
            )
        return out

    return run


def _quorum(mesh: Mesh, local):
    """The step around `local` (run on each position's shards, returning
    its verdict and its one-hot shard): one zeroed (n_inst,) int32 counts
    vector a distinct device, each shard's tally added into its device's
    vector, then `psum` over the distinct devices -> (verdict shards,
    counts replicated)."""

    def step(*args):
        outs = local(*args)
        n_inst = outs[0][1].shape[1]
        counts = {d: torch.zeros((n_inst,), dtype=torch.int32, device=d)
                  for d in mesh.distinct()}
        for d, (verdict, onehot) in zip(mesh.devices, outs):
            quorum_tally(onehot, verdict, out=counts[d])
        return [v for v, _ in outs], psum(counts, mesh)

    return step


def make_comb_quorum_step(mesh: Mesh, axis: str = "dp"):
    """The quorum step of the comb engine (the fast path).

    Returns step(s_nib, k_nib, a_idx, a_table, b_table, r_y, r_sign,
                 precheck, inst_onehot) -> (verdict shards, (B/k,) bool
                                            each, on its device;
                                            counts (n_inst,) int32 on
                                            every position)

    Per-item arrays split over `axis`; their batch dimension is TRAILING
    (limb/position-major layout, see ops/field25519.py), so 2-D arrays use
    P(None, axis). The comb tables replicate (the committee's keys, small
    and read-only). An argument may also be a list of tensors already
    placed, one a position.
    """
    vec = P(axis)  # (B,)
    mat = P(None, axis)  # (pos/limb, B)
    repl = P()

    def _local(s_nib, k_nib, a_idx, a_table, b_table, r_y, r_sign, precheck, onehot):
        verdict = comb.comb_verify_kernel(
            s_nib, k_nib, a_idx, a_table, b_table, r_y, r_sign, precheck
        )
        return verdict, onehot

    # pbftlint: disable=PBL006 -- parallel/mesh.shard_map is a torch helper that splits arguments over a Mesh of torch devices and calls the function on each shard; it builds no jit program, so there is no unwarmed dispatch surface to guard
    return _quorum(mesh, shard_map(
        _local, mesh, in_specs=(mat, mat, vec, repl, repl, mat, vec, vec, P(axis, None))))


def make_quorum_step(mesh: Mesh, axis: str = "dp"):
    """The quorum step of the ladder (no key bank).

    Returns step(a_y, a_sign, r_y, r_sign, s_bits, k_bits, precheck,
                 inst_onehot) -> (verdict shards, (B/k,) bool each, on its
                                  device; counts (n_instances,) int32 on
                                  every position)

    where inst_onehot is (B, n_instances) int32 mapping each vote to its
    consensus instance (all-zero rows = padding). Limb/bit-major arrays
    (a_y, r_y, s_bits, k_bits) have the batch axis trailing.
    """
    vec = P(axis)
    mat = P(None, axis)

    def _local(a_y, a_sign, r_y, r_sign, s_bits, k_bits, precheck, inst_onehot):
        verdict = verify_kernel(a_y, a_sign, r_y, r_sign, s_bits, k_bits, precheck)
        return verdict, inst_onehot

    # pbftlint: disable=PBL006 -- parallel/mesh.shard_map is a torch helper that splits arguments over a Mesh of torch devices and calls the function on each shard; it builds no jit program, so there is no unwarmed dispatch surface to guard
    return _quorum(mesh, shard_map(
        _local, mesh, in_specs=(mat, vec, mat, vec, mat, mat, vec, P(axis, None))))
