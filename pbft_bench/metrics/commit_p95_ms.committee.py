"""95th percentile of the client's send-to-acknowledgement time, ms, over every
request acknowledged in the window (nearest rank, as bench_consensus takes it)."""


def read(record):
    lat = sorted(record.get("window_latencies_ms") or [])
    if not lat:
        return None
    return lat[min(len(lat) - 1, int(0.95 * len(lat)))]
