"""90th percentile of the per-object encode time (host clock around each
``torch_encode_bytes`` call, which returns host bytes) over every object
of the window; ``statistics.quantiles``, inclusive."""

import statistics


def read(rec):
    t = rec["times"]
    if len(t) < 2:
        return None
    return statistics.quantiles(t, n=100, method="inclusive")[89]
