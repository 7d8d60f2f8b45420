"""The service's items a device pass, over the window (its counters at the edges)."""

from pbft_bench.metrics import items_per_pass


def read(record):
    return items_per_pass(record)
