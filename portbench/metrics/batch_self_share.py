"""The `batch` spans' own time, less their stage spans and host syncs,
over their wall time, in %: padding, copies, assembly and routing, from the
program's spans (no synchronise in them)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _program  # noqa: E402


def read(rec):
    return _program.self_share(rec, "batch")
