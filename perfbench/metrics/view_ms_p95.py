"""The 95th percentile of every view's latency in the window, in ms: each
view timed on the host clock from the call until the card has finished."""

import statistics


def read(r):
    lat = r.window.latencies
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94]
