"""Device-idle time while the innermost program span is `batch` (its own
time), `pad_h2d`, `assemble`, `otz1_fallback` or `staged`, or a host sync
of theirs, over the traced window, in %."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _program  # noqa: E402


def read(rec):
    return _program.idle_share(rec, "batch")
