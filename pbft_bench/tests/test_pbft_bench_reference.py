"""The plain references: RFC 8032's test vectors, the seeded signer, and
the verdicts of the seeded corruptions."""

import pytest

from pbft_bench import pool, signing
from pbft_bench.reference import ed25519
from pbft_bench.reference.kv import KV, state_mismatches

# RFC 8032 §7.1, tests 1-3: (secret key, public key, message, signature)
RFC8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bac"
     "c61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da085ac1e43e15996e"
     "458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025", "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac18ff9b538d16f290"
     "ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


@pytest.mark.parametrize("sk,pk,msg,sig", RFC8032)
def test_rfc8032_vectors(sk, pk, msg, sig):
    sk, pk, msg, sig = map(bytes.fromhex, (sk, pk, msg, sig))
    assert signing.expand(sk)[2] == pk
    assert signing.sign(sk, msg) == sig
    assert ed25519.verify(pk, msg, sig)
    assert not ed25519.verify(pk, msg + b"x", sig)


def test_policy_refuses_s_plus_l_and_a_noncanonical_r():
    sk, pk, msg, sig = map(bytes.fromhex, RFC8032[1])
    s = int.from_bytes(sig[32:], "little") + ed25519.L
    assert not ed25519.verify(pk, msg, sig[:32] + s.to_bytes(32, "little"))
    y = int.from_bytes(sig[:32], "little") & ((1 << 255) - 1)
    if y + ed25519.P < (1 << 255):  # the same y, encoded at or above p
        assert not ed25519.verify(pk, msg, (y + ed25519.P).to_bytes(32, "little") + sig[32:])
    assert not ed25519.verify(pk, msg, sig[:63])


def test_sign_many_gives_valid_distinct_signatures():
    seed = pool.key_seed(7, "r1")
    pub = signing.expand(seed)[2]
    msgs = [b"m%d" % i for i in range(6)]
    sigs = signing.sign_many(seed, msgs, b"votes")
    assert len(set(sigs)) == 6
    assert all(ed25519.verify(pub, m, s) for m, s in zip(msgs, sigs))
    assert sigs == signing.sign_many(seed, msgs, b"votes")


@pytest.mark.parametrize("layout", ["process_per_replica", "shared_service"])
def test_seeded_corruptions_are_what_the_reference_refuses(layout):
    cfg = {"n": 4, "clients": 2, "layout": layout}
    traffic = {"pool_items": 7 * 10, "corrupt_one_in": 5}
    rnd = pool.Round(cfg, seed=2**31 + 5, requests=pool.sweep_count(cfg, traffic))
    fp = pool.flood_pool(rnd, cfg, traffic, seed=2**31 + 5, rank=1)
    assert fp.items == 70 and all(len(s) == 7 for s in fp.sweeps)
    assert len(fp.kinds) == 70 // 5
    assert set(fp.kinds.values()) == set(pool.CORRUPTIONS)
    for sweep, want in zip(fp.sweeps, fp.verdicts):
        assert [ed25519.verify(*it) for it in sweep] == want


def test_pools_repeat_from_the_seed_and_differ_between_seeds():
    cfg = {"n": 4, "clients": 2, "layout": "process_per_replica"}
    traffic = {"pool_items": 14, "corrupt_one_in": 7}
    a, b, c = (pool.flood_pool(pool.Round(cfg, s, 2), cfg, traffic, s, 0) for s in (9, 9, 10))
    assert a.sweeps == b.sweeps and a.sweeps != c.sweeps


def test_inbound_sweep_is_what_a_replica_receives():
    rnd = pool.Round({"n": 4, "clients": 1}, seed=1, requests=1)
    kinds = [(rnd.msgs[m][0], rnd.msgs[m][1].split(b'"kind":"')[1].split(b'"')[0])
             for m in rnd.inbound_sweep(2, 0)]
    assert kinds == [("c0", b"request"), ("r0", b"preprepare"), ("r1", b"prepare"),
                     ("r3", b"prepare"), ("r0", b"commit"), ("r1", b"commit"),
                     ("r3", b"commit")]
    assert len(rnd.inbound_sweep(0, 0)) == 7


def test_kv_reference_and_state_comparison():
    kv = KV()
    assert kv.apply("put a 1") == "ok" and kv.apply("get a") == "1"
    assert kv.apply("bad") == "err:bad-op"
    assert state_mismatches({"a": "1"}, {"a": "1"}) == 0
    assert state_mismatches({"a": "1"}, {"a": "2", "b": "3"}) == 2
    assert state_mismatches({"a": "1"}, {"a": "2"}, either={"a": "2"}) == 0
