"""The control and the planted faults, by name (`--control`).

Each is applied in every process of a run, after set-up, to the timed
path as the program built it, and each must turn `correct` false:

- `malleable` (the floods' control): the program with its S < L
  precheck switched off, the one guarantee of the acceptance policy a
  host-staging change would be tempted to drop;
- `insecure` (the committee's control): the program's own `insecure`
  verifier in place of the card, which accepts every signature;
- `flip_verdict`: one verdict of every device pass inverted where the
  service hands it out;
- `half_pass`: a pass verifies the first half of its items and answers
  the rest as valid;
- `stale_state`: one replica acknowledges puts and leaves its store
  unchanged;
- `alter_reply`: every replica's store answers a put with another word.
"""

from __future__ import annotations

FLOOD = ("malleable", "flip_verdict", "half_pass")
COMMITTEE = ("insecure", "stale_state", "alter_reply")


def patch_service(name: str, svc, verifier) -> None:
    """Apply a flood control or fault to a built VerifyService."""
    if name == "malleable":
        import numpy as np

        from simple_pbft_tpu_torch.crypto import gpu_verifier

        gpu_verifier._ge_l_np = lambda s: np.zeros(len(s), dtype=bool)
    elif name == "flip_verdict":
        resolve = svc._resolve

        def flipped(subs, verdicts):
            verdicts = list(verdicts)
            verdicts[0] = not verdicts[0]
            resolve(subs, verdicts)

        svc._resolve = flipped
    elif name == "half_pass":
        dispatch = verifier.dispatch_batch

        def half(items):
            keep = len(items) // 2
            fin = dispatch(items[:keep])
            return lambda: fin() + [True] * (len(items) - keep)

        verifier.dispatch_batch = half
    else:
        raise SystemExit(f"{name!r} is not a flood control ({', '.join(FLOOD)})")


def patch_committee(name: str, com) -> None:
    """Apply a committee fault to a built LocalCommittee (the control
    `insecure` is applied where the committee is built)."""
    if name == "stale_state":
        app = com.replicas[1].app
        inner = getattr(app, "inner", app)
        inner.apply = lambda op: "ok"
    elif name == "alter_reply":
        # on the class, so that speculative forks of the store answer so too
        kv = type(getattr(com.replicas[0].app, "inner", com.replicas[0].app))
        apply = kv.apply
        kv.apply = lambda self, op: apply(self, op).upper()
    elif name != "insecure":
        raise SystemExit(f"{name!r} is not a committee control ({', '.join(COMMITTEE)})")
