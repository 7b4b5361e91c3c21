"""K1 (``match_depth_kernel``, the unmasked candidate depth loop): the bytes
of its launches by shape over its device time, in GB/s (``_shape_bw.py``).

A launch at (B, n) has as inputs the sorted match keys, positions and
ranks ((B, n) int32 each), the sorted dwords ((B, 16, n) int32) and the
segment ends ((B,) int32), and as outputs best_q, best_ro and best_len
((B, n) int32 each): 88 bytes a slot and 4 a row."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _shape_bw  # noqa: E402


def launch_bytes(b: int, n: int) -> int:
    return b * n * (3 * 4 + 16 * 4 + 3 * 4) + b * 4


def read(rec):
    return _shape_bw.gbps(rec, "match_depth", "match_depth_kernel", launch_bytes)
