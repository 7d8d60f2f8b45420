"""Seconds from process start to the window's first submission, every process of the cell."""


def read(record):
    return record["setup_s"]
