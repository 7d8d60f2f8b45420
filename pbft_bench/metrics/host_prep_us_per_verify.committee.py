"""Host staging time a verify: the `verify.host_prep` spans over their items."""

from pbft_bench.metrics import host_prep_us


def read(record):
    return host_prep_us(record)
