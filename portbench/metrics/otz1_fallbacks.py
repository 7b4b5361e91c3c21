"""Segments sent to the OTZ1 fallback by the batch layer in the window
(the program's ``device.batch.otz1_fallbacks``)."""


def read(rec):
    return rec["counters"]["otz1_fallbacks"]
