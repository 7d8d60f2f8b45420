"""Percent of the window the collector held each process, averaged over the processes."""


def read(record):
    if "gc_s" not in record:
        return None
    return 100.0 * record["gc_s"] / (record["window_s"] * record["processes"])
