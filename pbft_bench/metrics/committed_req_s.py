"""Client requests acknowledged in the window (f + 1 matching replies), a second."""

from pbft_bench.metrics import ratio


def read(record):
    return ratio(record, "committed", "window_s")
