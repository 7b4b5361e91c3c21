"""ROLZ match finder (reference src/matcher.rs); copied for the port from
``orz_tpu/golden/matcher.py``.

Per hash1 context (256 of them):
- a ring ("Bucket") of the last 4094 item-start positions, each carrying
  `match_len_min` (longest newer match against it, +1, clamped to 127) and
  `match_len_expected` (the match length emitted when the position itself was
  coded; 0 if it was a literal/word) — reference src/matcher.rs:28-100;
- hash chains over the ring keyed by a 4-byte rolling hash ("BucketMatcher"),
  encoder-only — reference src/matcher.rs:102-228.

The decoder keeps only the rings.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from orz_tpu_torch.constants import (
    HASH_DWORD_ADDS,
    HASH_DWORD_MULS,
    LZ_MATCH_MAX_LEN,
    LZ_MATCH_MIN_LEN,
    LZ_MF_BUCKET_ITEM_HASH_SIZE,
    LZ_MF_BUCKET_ITEM_SIZE,
    LZ_NUM_BUCKETS,
)

RING = LZ_MF_BUCKET_ITEM_SIZE
HASHN = LZ_MF_BUCKET_ITEM_HASH_SIZE


@dataclass
class Match:
    reduced_offset: int = 0
    match_len: int = 0
    match_len_expected: int = 0
    match_len_min: int = 0


def _dword_hash_exact(sbuf: np.ndarray, pos: int) -> int:
    # (b * MUL) ^ ADD per lane, then wrapping sum — note xor happens per lane
    # *before* summation (reference src/matcher.rs:261-262).
    total = 0
    for k in range(4):
        lane = ((int(sbuf[pos + k]) * HASH_DWORD_MULS[k]) & 0xFFFFFFFF) ^ HASH_DWORD_ADDS[k]
        total = (total + lane) & 0xFFFFFFFF
    return total


def dword_hash_entry(sbuf: np.ndarray, pos: int) -> int:
    return _dword_hash_exact(sbuf, pos) % HASHN


def _u32_at(sbuf: np.ndarray, pos: int) -> int:
    return int(sbuf[pos]) | int(sbuf[pos + 1]) << 8 | int(sbuf[pos + 2]) << 16 | int(sbuf[pos + 3]) << 24


def common_prefix_len(sbuf: np.ndarray, p1: int, p2: int, max_len: int) -> int:
    """First mismatching byte position, up to max_len (reference
    src/mem.rs:41-51; reads may run into the zero sentinel padding)."""
    a = sbuf[p1 : p1 + max_len]
    b = sbuf[p2 : p2 + max_len]
    neq = a != b
    idx = int(np.argmax(neq))
    return idx if neq[idx] else max_len


class MatcherState:
    """All 256 buckets (+ optional hash chains for the encoder side)."""

    def __init__(self, with_chains: bool):
        self.pos = np.zeros((LZ_NUM_BUCKETS, RING), dtype=np.int64)
        self.len_min = np.zeros((LZ_NUM_BUCKETS, RING), dtype=np.int64)
        self.expected = np.zeros((LZ_NUM_BUCKETS, RING), dtype=np.int64)
        self.head = np.zeros(LZ_NUM_BUCKETS, dtype=np.int64)
        self.with_chains = with_chains
        if with_chains:
            self.heads = np.full((LZ_NUM_BUCKETS, HASHN), -1, dtype=np.int64)
            self.nexts = np.full((LZ_NUM_BUCKETS, RING), -1, dtype=np.int64)

    # -- Bucket ops (reference src/matcher.rs:62-99) --

    def bucket_update(self, c: int, pos: int, reduced_offset: int, match_len: int) -> None:
        head = int(self.head[c])
        new_head = (head + 1) % RING
        if match_len >= LZ_MATCH_MIN_LEN:
            node = (head + RING - reduced_offset) % RING
            if self.len_min[c, node] <= match_len:
                self.len_min[c, node] = min(match_len + 1, 127)
        self.pos[c, new_head] = pos
        self.len_min[c, new_head] = 0
        self.expected[c, new_head] = match_len
        self.head[c] = new_head

    def forward(self, forward_len: int) -> None:
        np.subtract(self.pos, forward_len, out=self.pos)
        np.maximum(self.pos, 0, out=self.pos)
        if self.with_chains:
            # prune chain entries whose node was rebased to pos 0
            # (reference src/matcher.rs:123-133)
            for c in range(LZ_NUM_BUCKETS):
                h = self.heads[c]
                valid = h >= 0
                dead = np.zeros_like(valid)
                dead[valid] = self.pos[c][h[valid]] == 0
                h[dead] = -1
                nx = self.nexts[c]
                valid = nx >= 0
                dead = np.zeros_like(valid)
                dead[valid] = self.pos[c][nx[valid]] == 0
                nx[dead] = -1

    # -- BucketMatcher ops (encoder only) --

    def matcher_update(self, c: int, sbuf: np.ndarray, pos: int) -> None:
        """Insert the bucket's current head node into its hash chain; must be
        called after bucket_update (reference src/matcher.rs:115-121, called
        from src/lz.rs:196-200,208-212)."""
        entry = dword_hash_entry(sbuf, pos)
        head = int(self.head[c])
        self.nexts[c, head] = self.heads[c, entry]
        self.heads[c, entry] = head

    def find_match(self, c: int, sbuf: np.ndarray, sbuf_len: int, pos: int, match_depth: int) -> Match:
        """Walk the hash chain, keeping the longest common prefix
        (reference src/matcher.rs:135-192)."""
        entry = dword_hash_entry(sbuf, pos)
        node = int(self.heads[c, entry])
        if node < 0:
            return Match()
        max_len = LZ_MATCH_MIN_LEN - 1
        max_match_len_min = LZ_MATCH_MIN_LEN
        max_match_len_expected = LZ_MATCH_MIN_LEN
        max_node = 0
        node_pos = int(self.pos[c, node])
        max_len_dword = _u32_at(sbuf, pos + max_len - 3)

        for _ in range(match_depth):
            if _u32_at(sbuf, node_pos + max_len - 3) == max_len_dword:
                lcp = common_prefix_len(sbuf, node_pos, pos, LZ_MATCH_MAX_LEN)
                if lcp > max_len:
                    max_match_len_min = int(self.len_min[c, node])
                    max_match_len_expected = int(self.expected[c, node])
                    max_len = lcp
                    max_node = node
                    max_len_dword = _u32_at(sbuf, pos + max_len - 3)
                if lcp == LZ_MATCH_MAX_LEN:
                    break
                if max_match_len_expected > 0 and lcp > max_match_len_expected:
                    break
            node = int(self.nexts[c, node])
            if node < 0:
                break
            node_pos_next = int(self.pos[c, node])
            if node_pos <= node_pos_next:
                break
            node_pos = node_pos_next

        if max_len >= LZ_MATCH_MIN_LEN and pos + max_len < sbuf_len:
            return Match(
                reduced_offset=(int(self.head[c]) + RING - max_node) % RING,
                match_len=max_len,
                match_len_expected=max(max_match_len_expected, LZ_MATCH_MIN_LEN),
                match_len_min=max(max_match_len_min, LZ_MATCH_MIN_LEN),
            )
        return Match()

    def has_lazy_match(self, c: int, sbuf: np.ndarray, pos: int, min_match_len: int, depth: int) -> bool:
        """Probe whether any chain candidate matches at least min_match_len
        bytes (reference src/matcher.rs:194-228)."""
        entry = dword_hash_entry(sbuf, pos)
        node = int(self.heads[c, entry])
        if node < 0:
            return False
        node_pos = int(self.pos[c, node])
        for _ in range(depth):
            # mem_fast_equal is exact byte equality over min_match_len bytes
            # (reference src/mem.rs:55-70)
            if np.array_equal(sbuf[node_pos : node_pos + min_match_len], sbuf[pos : pos + min_match_len]):
                return True
            node = int(self.nexts[c, node])
            if node < 0:
                break
            node_pos_next = int(self.pos[c, node])
            if node_pos <= node_pos_next:
                break
            node_pos = node_pos_next
        return False

    def get_node(self, c: int, reduced_offset: int):
        """Decoder-side ring lookup (reference src/matcher.rs:89-99)."""
        node = (int(self.head[c]) + RING - reduced_offset) % RING
        return (
            int(self.pos[c, node]),
            int(self.len_min[c, node]),
            int(self.expected[c, node]),
        )
