"""QUALITY (its scan and its tail, each synchronised, through the batch
layer's ``stage`` hook) over the batch wall time, in %."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _stage  # noqa: E402


def read(rec):
    return _stage.share(rec, ("QUALITY scan", "QUALITY tail"))
