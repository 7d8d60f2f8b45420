"""A fixed adversarial batch for the ladder mode (`GpuVerifier(mode="ladder")`).

The ladder mode decompresses every key on the device, where no key bank
has checked it first, so its kernel and its plain version are held
against each other, and against the CPU oracle, on keys and signatures
that a bank would never pass on. The tests and chip_smoke.py share it.
"""

from __future__ import annotations

from . import ed25519_cpu as ref
from .verifier import BatchItem

# an Ed25519 point of order 8: a small-order key
ORDER8_POINT = bytes.fromhex("26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05")


def ladder_adversarial_items():
    """The ladder mode's fixed adversarial batch: keys the device
    decompresses itself, which no bank ever sees. -> [(name, item)], one
    row of each kind: A.y = p (>= p), a non-residue A.y, A with x = 0 and
    sign 1, a small-order A (order 8) and the identity A, each with a
    signature that the cofactorless equation accepts where one exists
    (S B = R and 8 | k), S >= L, a wrong length, a swapped key."""
    seeds = [bytes([i + 1]) * 32 for i in range(2)]
    pubs = [ref.public_key(seed) for seed in seeds]
    msg = b"ladder adversarial"
    sig = ref.sign(seeds[0], msg)

    def enc(y, sign=0):
        return (y | sign << 255).to_bytes(32, "little")

    non_residue = next(y for y in range(2, 64) if ref._recover_x(y, 0) is None)
    s = 0x1234567
    r_enc = ref.point_compress(ref.point_mul(s, ref.B))
    forged = r_enc + s.to_bytes(32, "little")  # S B = R: k A must vanish
    small_msg = next(m for m in (b"small order %d" % i for i in range(256))
                     if ref.challenge_scalar(r_enc, ORDER8_POINT, m) % 8 == 0)
    s_plus_l = (int.from_bytes(sig[32:], "little") + ref.L).to_bytes(32, "little")
    return [
        ("a_y_ge_p", BatchItem(enc(ref.P), msg, sig)),
        ("a_non_residue", BatchItem(enc(non_residue), msg, sig)),
        ("a_x0_sign1", BatchItem(enc(1, 1), msg, forged)),
        ("a_small_order", BatchItem(ORDER8_POINT, small_msg, forged)),
        ("a_identity", BatchItem(enc(1), msg, forged)),
        ("s_ge_l", BatchItem(pubs[0], msg, sig[:32] + s_plus_l)),
        ("wrong_length", BatchItem(pubs[0][:31], msg, sig)),
        ("swapped_key", BatchItem(pubs[1], msg, sig)),
    ]
