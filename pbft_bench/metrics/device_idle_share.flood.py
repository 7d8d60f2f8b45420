"""Percent of the traced window in which the card ran nothing (all processes' traces joined)."""

from pbft_bench.metrics import idle_share


def read(record):
    return idle_share(record)
