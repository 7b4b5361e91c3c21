"""The `encode` spans' own time, less the `batch` spans under them, over
their wall time, in %: the container layer's reading, batching and framing,
from the program's spans (no synchronise in them)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _program  # noqa: E402


def read(rec):
    return _program.self_share(rec, "encode")
