"""Consensus plane: pure state machine, pools, replica runtime.

Layer map (cf. SURVEY.md §1 for the reference's layers):

- ``state``      — per-(view, seq) instance state machine, pure logic
                   (reference L2: pbft/consensus/pbft_impl.go). Its vote
                   maps double as the out-of-order buffers the reference
                   kept in pool/*.go, re-keyed by (view, seq) per the
                   author's gap notes (需要改进的地方.md:22-24).
- ``replica``    — event-driven replica runtime: many instances in flight,
                   batched signature verification, checkpointing, state
                   transfer (reference L3: pbft/network/node.go, minus
                   the 1 s tick).
- ``viewchange`` — VIEW-CHANGE / NEW-VIEW certificates and the failover
                   timer machine (the reference's view.go was dead code).
"""

from .state import Instance, Stage  # noqa: F401
