"""Signatures verified in the window, summed over the processes, a second."""

from pbft_bench.metrics import ratio


def read(record):
    return ratio(record, "verifies", "window_s")
