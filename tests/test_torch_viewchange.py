"""The port's view change on the device path, against the JAX package's.

BASELINE config 5 (the view-change storm) is the one path on which
VIEW-CHANGE and NEW-VIEW certificates reach the verifier: the replica's
drain sweep flattens every nested signature of a certificate into the
same verify pile as ordinary traffic. Here, on the CPU and at batch
buckets of at most 32:

- a NEW-VIEW built at n = 4 with the same helpers in each package gives
  the same signature items byte for byte, and with one signature of each
  kind tampered (a nested prepare, a VIEW-CHANGE envelope, a re-issued
  pre-prepare, the NEW-VIEW envelope) the port's GpuVerifier(device="cpu")
  gives the JAX TpuVerifier's bitmap, which is the oracle's item by item;
- a port committee whose every pass goes through GpuVerifier(device="cpu")
  fails over from a crashed primary and ends in the state a JAX committee
  ends in after the same requests;
- a pile larger than the top bucket splits into chunks of it, in order,
  with the oracle's verdicts;
- the port's edits to its copies of the message and view-change modules,
  which cut an in-process committee's certificate work, give the JAX
  functions' answers: the nesting bound, the NEW-VIEW walk's memo, the
  shared decode of large frames and the cached signing payloads.
"""

import asyncio
import importlib

import pytest

from simple_pbft_tpu.crypto import tpu_verifier as jtv
from simple_pbft_tpu_torch.crypto import ed25519_cpu as ref
from simple_pbft_tpu_torch.crypto import gpu_verifier
from simple_pbft_tpu_torch.crypto.coalesce import VerifyService
from simple_pbft_tpu_torch.crypto.gpu_verifier import GpuVerifier
from simple_pbft_tpu_torch.crypto.verifier import BatchItem


def _pkg(name):
    """The modules of one package that build and check a certificate."""
    mods = ("config", "messages", "crypto.signer", "crypto.verifier", "consensus.viewchange")
    return {m.split(".")[-1]: importlib.import_module(f"{name}.{m}") for m in mods}


def _new_view(name):
    """n = 4: VIEW-CHANGEs of r1, r2, r3 for view 1, r1's carrying a
    prepared proof of seq 1 (its pre-prepare and 3 prepares), and the
    NEW-VIEW that view 1's primary builds from them (as
    tests/test_viewchange.py builds them). -> (the NEW-VIEW's signature
    items as a replica's sweep collects them: its envelope, then what
    validate_new_view emits; the signed messages in the same order)."""
    p = _pkg(name)
    msgs = p["messages"]
    cfg, keys = p["config"].make_test_committee(n=4)

    def sign(sender, msg):
        p["signer"].Signer(sender, keys[sender].seed).sign_msg(msg)
        return msg

    req = sign("c0", msgs.Request(client_id="c0", timestamp=1, operation="put k v"))
    block = [req.to_dict()]
    pp = sign(cfg.primary(0), msgs.PrePrepare(
        view=0, seq=1, digest=msgs.PrePrepare.block_digest(block), block=block))
    prepares = [sign(rid, msgs.Prepare(view=0, seq=1, digest=pp.digest))
                for rid in cfg.replica_ids[: cfg.quorum]]
    proof = {"pre_prepare": pp.to_dict(), "prepares": [q.to_dict() for q in prepares]}
    vcs = [sign(rid, msgs.ViewChange(new_view=1, stable_seq=0, checkpoint_proof=[],
                                     prepared_proofs=[proof] if rid == "r1" else []))
           for rid in ("r1", "r2", "r3")]
    vc_mod = p["viewchange"]
    _, o_set = vc_mod.compute_o_set(cfg, {v.sender: v for v in vcs}, 1)
    primary = cfg.primary(1)
    reissued = [sign(primary, msgs.PrePrepare(view=1, seq=seq, digest=digest, block=[]))
                for seq, digest in o_set]
    nv = sign(primary, msgs.NewView(new_view=1, viewchange_proof=[v.to_dict() for v in vcs],
                                    pre_prepares=[q.to_dict() for q in reissued]))
    res = vc_mod.validate_new_view(cfg, nv)
    assert res is not None
    envelope = p["verifier"].BatchItem(cfg.pubkey(nv.sender), nv.signing_payload(),
                                       bytes.fromhex(nv.sig))
    signed = [nv, vcs[0], pp, *prepares, vcs[1], vcs[2], *reissued]
    return [envelope, *res[1]], signed


def _tamper(item, byte):
    sig = bytearray(item.sig)
    sig[byte] ^= 0x10
    return BatchItem(item.pubkey, item.msg, bytes(sig))


# positions in the sweep: 0 the NEW-VIEW envelope, 1 r1's VIEW-CHANGE
# envelope, 2 its proof's pre-prepare, 3-5 the proof's prepares, 6 and 7
# r2's and r3's VIEW-CHANGE envelopes, 8 the re-issued pre-prepare
TAMPERED = {3: "a nested prepare", 6: "a VIEW-CHANGE envelope",
            8: "a re-issued pre-prepare", 0: "the NEW-VIEW envelope"}


@pytest.fixture(scope="module")
def certificates():
    return _new_view("simple_pbft_tpu_torch"), _new_view("simple_pbft_tpu")


def test_new_view_items_are_the_jax_packages_byte_for_byte(certificates):
    (port, port_msgs), (jax, jax_msgs) = certificates
    assert len(port) == len(jax) == 9
    assert [(i.pubkey, i.msg, i.sig) for i in port] == [(i.pubkey, i.msg, i.sig) for i in jax]
    # each item is the signature of the message at its position
    assert [i.msg for i in port] == [m.signing_payload() for m in port_msgs]
    assert [bytes.fromhex(m.sig) for m in port_msgs] == [i.sig for i in port]
    assert [type(m).__name__ for m in port_msgs] == [
        "NewView", "ViewChange", "PrePrepare", "Prepare", "Prepare", "Prepare",
        "ViewChange", "ViewChange", "PrePrepare"]


@pytest.mark.parametrize("byte", [40, 5], ids=["S", "R"])
def test_tampered_certificate_bitmap_equals_jax_and_the_oracle(certificates, byte):
    (items, _), _ = certificates
    items = [_tamper(it, byte) if i in TAMPERED else it for i, it in enumerate(items)]
    oracle = [ref.verify(i.pubkey, i.msg, i.sig) for i in items]
    assert oracle == [i not in TAMPERED for i in range(len(items))]
    got = GpuVerifier(device="cpu").verify_batch(items)
    assert got == jtv.TpuVerifier().verify_batch(items) == oracle


REQUESTS = ("put a 1", "put b 2", "put c 3")


def _failover(com, settle=15.0):
    """Commit REQUESTS[0], crash-stop r0 (view 0's primary), then commit
    the rest through a view change (as tests/test_viewchange.py's
    failover test does); wait until every survivor has executed them.
    -> the survivors."""

    async def scenario():
        com.start()
        try:
            client = com.clients[0]
            client.request_timeout = 0.25
            # the plain versions' passes on a busy host can outlast the
            # 0.3 s timer before r0 is killed too: patience for every op
            assert await client.submit(REQUESTS[0], retries=60) == "ok"
            com.replica("r0").kill()
            for op in REQUESTS[1:]:
                assert await client.submit(op, retries=60) == "ok"
            survivors = [r for r in com.replicas if r.id != "r0"]
            loop = asyncio.get_running_loop()
            deadline = loop.time() + settle
            while loop.time() < deadline and not all(
                    r.app.data.get("c") == "3" for r in survivors):
                await asyncio.sleep(0.05)
            return survivors
        finally:
            await com.stop()

    return asyncio.run(asyncio.wait_for(scenario(), 180))


def test_failover_on_the_device_path_matches_the_jax_committee():
    from simple_pbft_tpu.committee import LocalCommittee as JaxCommittee
    from simple_pbft_tpu_torch.committee import LocalCommittee

    gpu = GpuVerifier(device="cpu", initial_keys=4 + 1 + 32)
    svc = VerifyService(gpu, cpu_cutoff=0, max_batch=32, dispatch_deadline=None)
    try:
        com = LocalCommittee.build(n=4, clients=1, view_timeout=0.3,
                                   verifier_factory=lambda: svc)
        # the service takes a submission larger than max_batch whole: a
        # sweep holding a NEW-VIEW and its certificates' signatures can
        # reach the 128 bucket
        svc.warm_for_population([com.cfg.pubkeys[k] for k in sorted(com.cfg.pubkeys)],
                                max_sweep=128)
        survivors = _failover(com)
    finally:
        svc.close()
    assert all(r.view >= 1 and r.app.data.get("c") == "3" for r in survivors)
    assert sum(r.metrics.get("views_installed", 0) for r in survivors) > 0
    assert all(r.metrics.get("bad_newview_precheck", 0) == 0 for r in survivors)
    assert svc.device_passes > 0 and svc.cpu_passes == 0 and svc.watchdog_failovers == 0
    assert gpu.post_warm_compiles == 0 and gpu.launch_tally()["chunks"] > 0
    digests = {r.app.state_digest() for r in survivors}
    assert len(digests) == 1

    ref_survivors = _failover(JaxCommittee.build(n=4, clients=1, view_timeout=0.3))
    assert all(r.view >= 1 and r.app.data.get("c") == "3" for r in ref_survivors)
    assert {r.app.state_digest() for r in ref_survivors} == digests


BAD = (31, 32, 63, 64)


def test_pile_over_the_top_bucket_splits_into_chunks_in_order(monkeypatch):
    """A 70-item pile at a top bucket of 32: chunks of 32, 32 and 6, in
    order, their verdicts the oracle's, the bad signatures on both sides
    of each chunk edge."""
    monkeypatch.setattr(gpu_verifier, "BUCKETS", (8, 32))
    seeds = [bytes([i + 1]) * 32 for i in range(5)]
    items = []
    for i in range(70):
        seed = seeds[i % len(seeds)]
        msg = b"pile item %d" % i
        items.append(BatchItem(ref.public_key(seed), msg, ref.sign(seed, msg)))
    items = [_tamper(it, 40) if i in BAD else it for i, it in enumerate(items)]
    oracle = [ref.verify(i.pubkey, i.msg, i.sig) for i in items]
    assert oracle == [i not in BAD for i in range(70)]
    gpu = GpuVerifier(device="cpu", initial_keys=8)
    gpu.warm_for_population([it.pubkey for it in items[:5]], max_sweep=32)
    chunks = []
    real = gpu._dispatch_chunk
    monkeypatch.setattr(gpu, "_dispatch_chunk",
                        lambda chunk, *a: chunks.append(list(chunk)) or real(chunk, *a))
    assert gpu.verify_batch(items) == oracle
    assert chunks == [items[:32], items[32:64], items[64:]]
    tally = gpu.launch_tally()
    assert tally["chunks"] == 3 and tally["chunked_dispatches"] == 1
    assert tally["max_dispatch_items"] == 70 and gpu.post_warm_compiles == 0


def _nested(depth, inner, wrap):
    obj = inner
    for i in range(depth):
        obj = [obj, 1] if wrap(i) == "list" else {"k": obj, "n": 2}
    return obj


DEPTH_CASES = [(d, inner, kind) for d in (15, 16, 17, 18) for inner in (0, [], {}, [0], "s")
               for kind in ("list", "dict", "mixed")]


@pytest.mark.parametrize("depth,inner,kind", DEPTH_CASES)
def test_depth_check_raises_where_the_jax_walk_does(depth, inner, kind):
    """The port's level-by-level nesting bound against the JAX package's
    pair-by-pair walk: the same verdict on every input around the bound
    (scalars, empty and non-empty containers at depths 15 to 18)."""
    from simple_pbft_tpu import messages as jmessages
    from simple_pbft_tpu_torch import messages as tmessages

    obj = _nested(depth, inner, lambda i: kind if kind != "mixed" else ("list", "dict")[i % 2])

    def verdict(check):
        try:
            check(obj)
        except ValueError:
            return "raises"
        return "passes"

    assert verdict(tmessages._check_depth) == verdict(jmessages._check_depth)


def test_new_view_walk_runs_once_a_process_per_content_and_config(certificates):
    """validate_new_view's memo: the same certificate under the same
    config is walked once and its result shared; another config object,
    or a certificate that differs in one byte, is walked anew; an invalid
    certificate's None is kept like any result."""
    from simple_pbft_tpu_torch import config as tconfig
    from simple_pbft_tpu_torch.consensus import viewchange
    from simple_pbft_tpu_torch.messages import Message

    (_, port_msgs), _ = certificates
    wire = port_msgs[0].to_wire()
    cfg, _ = tconfig.make_test_committee(n=4)
    walks = []
    real = viewchange._validate_new_view

    def counted(*a):
        walks.append(a)
        return real(*a)

    viewchange._NV_MEMO.clear()
    try:
        viewchange._validate_new_view = counted
        first = viewchange.validate_new_view(cfg, Message.from_wire(wire))
        again = viewchange.validate_new_view(cfg, Message.from_wire(wire))
        assert first is not None and again is first and len(walks) == 1
        other_cfg, _ = tconfig.make_test_committee(n=4)
        assert viewchange.validate_new_view(other_cfg, Message.from_wire(wire)) is not first
        assert len(walks) == 2
        bad = Message.from_wire(wire)
        bad.pre_prepares = []
        assert viewchange.validate_new_view(cfg, bad) is None
        assert viewchange.validate_new_view(cfg, bad) is None and len(walks) == 3
    finally:
        viewchange._validate_new_view = real
        viewchange._NV_MEMO.clear()


def _big_frames(pkg):
    """A pre-prepare with a 400-request block and a VIEW-CHANGE carrying it
    as a prepared proof, both over SHARED_DECODE_BYTES on the wire, built
    by one package's messages (nothing is signed: decoding is checked)."""
    m = importlib.import_module(f"{pkg}.messages")
    block = [m.Request(client_id="c0", timestamp=i, operation=f"put key{i} {'v' * 150}").to_dict()
             for i in range(400)]
    pp = m.PrePrepare(view=0, seq=1, digest=m.PrePrepare.block_digest(block), block=block,
                      sender="r0", sig="ab" * 64)
    vc = m.ViewChange(new_view=1, prepared_proofs=[{"pre_prepare": pp.to_dict(), "prepares": []}],
                      sender="r1", sig="cd" * 64)
    return m, [pp.to_wire(), vc.to_wire()]


def test_large_frames_decode_once_a_process_into_messages_of_their_own():
    """from_wire on a large frame gives the JAX package's message (the same
    fields and signing payload), and again on the same bytes a message of
    its own, built from the decode the first call made."""
    from simple_pbft_tpu_torch import messages as tmessages

    jm, jframes = _big_frames("simple_pbft_tpu")
    tm, frames = _big_frames("simple_pbft_tpu_torch")
    assert frames == jframes
    for raw in frames:
        assert len(raw) >= tmessages.SHARED_DECODE_BYTES
        want = jm.Message.from_wire(raw)
        first = tm.Message.from_wire(raw)
        again = tm.Message.from_wire(bytes(raw))  # equal bytes, another object
        assert first is not again and type(first).__name__ == type(want).__name__
        for got in (first, again):
            assert got.to_dict() == want.to_dict()
            assert got.signing_payload() == want.signing_payload()
        # the callers' private state and top-level fields are their own
        first._validated = "first only"
        assert getattr(again, "_validated", None) is None
        again.sender = "r9"
        assert first.sender == want.sender
        assert again.signing_payload() != first.signing_payload()


def test_cached_payloads_follow_field_changes_as_the_jax_ones():
    """PrePrepare's and ViewChange's signing payloads, now cached, equal
    the JAX package's after each field change (a change drops the cache)."""
    jm, _ = _big_frames("simple_pbft_tpu")
    tm, _ = _big_frames("simple_pbft_tpu_torch")
    pair = [(m.PrePrepare(view=2, seq=5, digest="aa" * 32, block=[{"x": 1}], sender="r2"),
             m.ViewChange(new_view=3, stable_seq=0, sender="r3")) for m in (tm, jm)]
    (tpp, tvc), (jpp, jvc) = pair
    steps = [lambda pp, vc: None,
             lambda pp, vc: setattr(pp, "block", []),
             lambda pp, vc: setattr(pp, "digest", "bb" * 32),
             lambda pp, vc: setattr(vc, "checkpoint_proof", [{"seq": 64}]),
             lambda pp, vc: setattr(vc, "stable_seq", 64),
             lambda pp, vc: setattr(vc, "sig", "ef" * 64)]
    for step in steps:
        step(tpp, tvc)
        step(jpp, jvc)
        assert tpp.signing_payload() == jpp.signing_payload()
        assert tvc.signing_payload() == jvc.signing_payload()
