"""K2 (``match_depth_masked_kernel``, the masked candidate depth loop of
QUALITY): the bytes of its launches by shape over its device time, in GB/s
(``_shape_bw.py``).

A launch at (B, n) has K1's inputs (keys, positions, ranks: (B, n) int32;
dwords (B, 16, n) int32; ends (B,) int32) and the mask ((B, n) bool), and
K1's outputs (best_q, best_ro, best_len: (B, n) int32 each): 89 bytes a
slot and 4 a row."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _shape_bw  # noqa: E402


def launch_bytes(b: int, n: int) -> int:
    return b * n * (3 * 4 + 16 * 4 + 1 + 3 * 4) + b * 4


def read(rec):
    return _shape_bw.gbps(rec, "match_depth_masked", "match_depth_masked_kernel",
                          launch_bytes)
