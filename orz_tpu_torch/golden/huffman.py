"""Static canonical Huffman coding (reference src/huffman.rs); copied for
the port from ``orz_tpu/golden/huffman.py``.

Tree construction uses a min-heap ordered by (weight, node index) — the
reference's BinaryHeap behaves as a min-heap via its reversed PartialOrd
(reference src/huffman.rs:34-39); ties pop the lowest index first, and freshly
combined internal nodes always carry indices above all symbols.

If the resulting max code length exceeds the limit, all nonzero weights are
divided by 2^(excess) (clamped to >= 1) and the tree is rebuilt (reference
src/huffman.rs:98-109).

Canonical code assignment orders symbols by (code_len, symbol) and hands out
consecutive codes (reference src/huffman.rs:118-141).  Decoding uses a flat
LUT over max_code_len bits (reference src/huffman.rs:149-167).
"""

from __future__ import annotations

import heapq
from typing import List, Sequence, Tuple


def build_code_lens(sym_weights: Sequence[int], max_code_len: int) -> Tuple[List[int], int]:
    """Return (code_lens, actual_max_code_len)."""
    n = len(sym_weights)
    weights = list(sym_weights)
    while True:
        heap = [(weights[i], i) for i in range(n) if sym_weights[i] > 0]
        heapq.heapify(heap)
        if len(heap) <= 1:
            code_lens = [0] * n
            if heap:
                code_lens[heap[0][1]] = 1
                return code_lens, 1
            return code_lens, 0

        node_weights = list(weights)
        children: List[Tuple[int, int]] = []  # for nodes >= n: (child1, child2)
        while len(heap) > 1:
            w1, i1 = heapq.heappop(heap)
            w2, i2 = heapq.heappop(heap)
            new_index = n + len(children)
            node_weights.append(w1 + w2)
            children.append((i1, i2))
            heapq.heappush(heap, (w1 + w2, new_index))

        lens_all = [0] * len(node_weights)
        for i in range(len(node_weights) - 1, n - 1, -1):
            c1, c2 = children[i - n]
            lens_all[c1] = lens_all[i] + 1
            lens_all[c2] = lens_all[i] + 1
        code_lens = lens_all[:n]

        cur_max = max(code_lens)
        if cur_max > max_code_len:
            shrink = 1 << (cur_max - max_code_len)
            weights = [max(w // shrink, 1) if w > 0 else 0 for w in weights]
            continue
        return code_lens, cur_max


def canonical_encodings(code_lens: Sequence[int]) -> List[Tuple[int, int]]:
    """sym -> (code, code_len); zero-length symbols get (0, 0)."""
    encodings = [(0, 0)] * len(code_lens)
    ordered = sorted(
        (s for s in range(len(code_lens)) if code_lens[s] > 0),
        key=lambda s: (code_lens[s], s),
    )
    bits = 0
    cur_len = 1
    for sym in ordered:
        shift = code_lens[sym] - cur_len
        if shift > 0:
            bits <<= shift
            cur_len += shift
        encodings[sym] = (bits, code_lens[sym])
        bits += 1
    return encodings


class HuffmanDecoding:
    """Flat (sym, code_len) LUT over max_code_len peeked bits."""

    __slots__ = ("lut", "max_code_len")

    def __init__(self, code_lens: Sequence[int], max_code_len: int):
        self.max_code_len = max_code_len
        lut = [(0, 0)] * (1 << max_code_len)
        for sym, (code, code_len) in enumerate(canonical_encodings(code_lens)):
            if code_len > 0:
                rest = max_code_len - code_len
                base = code << rest
                for k in range(1 << rest):
                    lut[base + k] = (sym, code_len)
        self.lut = lut
