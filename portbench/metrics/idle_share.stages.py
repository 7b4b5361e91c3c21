"""Device-idle time while inside a stage span (FRONT, QUALITY scan, QUALITY
tail, MID2 or MID, BACK; their host syncs included), over the traced
window, in %: Python and torch's per-op dispatch between launches."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _program  # noqa: E402


def read(rec):
    return _program.idle_share(rec, "stages")
