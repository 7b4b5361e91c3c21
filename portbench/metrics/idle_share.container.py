"""Device-idle time while the innermost program span is `encode`, `read` or
`frame` (the container layer), over the traced window, in %."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _program  # noqa: E402


def read(rec):
    return _program.idle_share(rec, "container")
