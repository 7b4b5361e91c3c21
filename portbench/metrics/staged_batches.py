"""Batches sent whole to the staged encoder by an empty segment or symrank
skew in the window (the program's ``device.batch.staged_batches``)."""


def read(rec):
    p = rec.get("program")
    return p["counters"]["staged_batches"] if p else None
