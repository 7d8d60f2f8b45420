"""The mean of the committee's event-loop lag samples taken in the window, ms."""

from pbft_bench.metrics import ratio


def read(record):
    return ratio(record, "loop_lag_sum_ms", "loop_lag_samples")
