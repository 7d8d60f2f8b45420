"""The multi-device dry run: the port's twin of the JAX package's
``__graft_entry__.dryrun_multichip``.

    python -m simple_pbft_tpu_torch.parallel.dryrun [n_devices] [--device cpu]

runs, step for step as the JAX entry does, on a mesh of `n_devices`
positions of one device (``cuda`` unless asked for the CPU):

1. the comb quorum step on 2 in-flight consensus instances, one vote per
   (device, instance): every vote valid, each instance counting half;
2. a meshed fused GpuVerifier on the same number of signed items, one of
   them corrupted;
3. a coalescing VerifyService over that verifier, with its CPU route
   turned off, folding three submissions into device passes.

Any failed check raises.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..crypto import ed25519_cpu as ref
from ..crypto.gpu_verifier import GpuVerifier, KeyBank, prepare_comb_batch
from ..crypto.verifier import BatchItem
from ..ops import comb
from .mesh import Mesh, gather
from .sharded_verify import make_comb_quorum_step


def _signed_items(n: int, n_keys: int = 4, tag: bytes = b"graft"):
    """n valid (pubkey, msg, sig) tuples from deterministic seeds."""
    items = []
    for i in range(n):
        seed = bytes([i % n_keys + 1]) * 32
        msg = tag + b" vote %d" % i
        items.append(BatchItem(ref.public_key(seed), msg, ref.sign(seed, msg)))
    return items


def _comb_args(batch: int, device):
    bank = KeyBank(device=device, mode="comb")
    prep, _ = prepare_comb_batch(_signed_items(batch), bank)
    prep = prep.padded(batch)
    tables = bank.device_tables()
    b_table = comb.base_table_device(device)
    s_nib, k_nib, a_idx, r_y, r_sign, precheck = prep.arrays()
    return (s_nib, k_nib, a_idx, tables, b_table, r_y, r_sign, precheck)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the sharded consensus step over an n_devices mesh of `device`
    on tiny shapes: 2 in-flight consensus instances, one vote per (device,
    instance), the batch split over the mesh, the key tables replicated,
    the quorum tally summed over the mesh; then the meshed fused verifier
    alone and behind a VerifyService."""
    mesh = Mesh([device] * n_devices)
    device = mesh.devices[0]

    n_inst = 2
    batch = 2 * n_devices  # one vote per (device, instance)
    args = _comb_args(batch, device)
    inst = np.arange(batch, dtype=np.int32) % n_inst
    onehot = np.eye(n_inst, dtype=np.int32)[inst]

    step = make_comb_quorum_step(mesh)
    verdict, counts = step(*args, onehot)
    verdict = gather(verdict)
    if not verdict.all():
        raise RuntimeError(f"valid votes rejected: {verdict}")
    for c in counts:
        if not (c.cpu().numpy() == batch // n_inst).all():
            raise RuntimeError(f"bad quorum tally: {c}")

    # the fused engine over the same mesh: each position runs the pass on
    # its shard of the batch, on its device
    from ..crypto.coalesce import VerifyService

    v = GpuVerifier(device=device, mesh=mesh, mode="fused")
    seed = b"\x42" * 32
    items = [
        BatchItem(ref.public_key(seed), b"mc %d" % i, ref.sign(seed, b"mc %d" % i))
        for i in range(batch)
    ]
    bad = bytearray(items[1].sig)
    bad[2] ^= 4
    items[1] = BatchItem(items[1].pubkey, items[1].msg, bytes(bad))
    want = [i != 1 for i in range(batch)]
    got = v.verify_batch(items)
    if got != want:
        raise RuntimeError(f"meshed verdicts {got}, expected {want}")

    # the coalescing service folds concurrent replicas' submissions into
    # one sharded device pass, forced past the CPU cutoff so the dry run
    # proves the DEVICE route end to end
    svc = VerifyService(v, cpu_cutoff=0)
    try:
        # the bucket the coalesced pile can pad to (3 x batch items), as
        # the JAX dry run pre-pays its compile
        v.verify_batch(items * 3)
        futs = [svc.submit(items) for _ in range(3)]
        for f in futs:
            got = f.result(120)
            if got != want:
                raise RuntimeError(f"coalesced verdicts {got}, expected {want}")
        if svc.device_passes < 1:
            raise RuntimeError("the coalesced pass never reached the device")
    finally:
        svc.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-device dry run of the port")
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda", help="the torch device every position uses")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)
    print(f"dryrun_multichip({args.n_devices}, device={args.device!r}): ok")


if __name__ == "__main__":
    main()
