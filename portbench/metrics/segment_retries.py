"""Segments re-encoded by the container's per-segment retry in the window
(the program's ``device.container.segment_retries``)."""


def read(rec):
    return rec["counters"]["segment_retries"]
