"""Shared pieces of the text generators: a vocabulary and a renderer that
turns token ids into bytes without a Python loop per token."""

from __future__ import annotations

import numpy as np

import rng

COMMON = (
    "the of and in to a is was for as on by with he that from at his it an "
    "are were which be this also or has had first one their its new after "
    "who they two her she but not been have all other were city into more "
    "year only over most some time would there school between during him "
    "many up than made these when may united states world under three "
    "national can known war such while where years both since through used "
    "became about what later then no however american part each being "
    "before them state because family did team several until those second "
    "early government life same so people century series north south area "
    "film like four number work name around music any well against called "
    "including well will own group we could high following game same off"
).split()

ONSETS = ("", "", "", "b", "c", "d", "f", "g", "h", "l", "m", "n", "p", "r",
          "s", "t", "w", "v", "th", "st", "ch", "sh", "pr", "tr", "br", "cr",
          "gr", "pl", "cl", "wh", "k", "j", "sp", "fr")
VOWELS = ("a", "e", "i", "o", "u", "a", "e", "i", "o", "ea", "ou", "io",
          "ai", "ee", "y", "ie", "oo")
CODAS = ("", "", "", "", "n", "r", "s", "t", "l", "d", "nd", "st", "ng",
         "ss", "ll", "rt", "nt", "ck", "m", "ght", "ted", "ing", "tion", "ed",
         "er", "ly", "es", "ment", "ity", "al", "ous")


def vocabulary(r, n: int, common=COMMON) -> list[bytes]:
    """`n` distinct lower-case words: `common` first, then words of one to
    four syllables ordered by length (short words are the frequent ones),
    drawn from the stream seeded by the Python generator `r`."""
    seen = set(common)
    out = list(dict.fromkeys(common))
    made = []
    k = rng.key(r.getrandbits(63))
    batch = 0
    while len(out) + len(made) < n:
        m = 2 * n
        z = rng.u64(rng.key(k, batch), m)
        batch += 1
        ks = 1 + np.minimum(z & 7, (z >> 3) & 7).astype(np.int64) // 2
        parts = [((z >> np.uint64(8 + 15 * j)) & 0x7FFF).astype(np.int64)
                 for j in range(4)]
        syl = [[ONSETS[v % len(ONSETS)] + VOWELS[(v >> 5) % len(VOWELS)]
                + CODAS[(v >> 10) % len(CODAS)] for v in p.tolist()]
               for p in parts]
        for i, kk in enumerate(ks.tolist()):
            w = "".join(syl[j][i] for j in range(kk))
            if w not in seen and len(w) > 1:
                seen.add(w)
                made.append(w)
                if len(out) + len(made) == n:
                    break
    made.sort(key=len)
    return [w.encode() for w in out + made][:n]


class Table:
    """Byte strings by id; ``render`` concatenates a run of ids."""

    def __init__(self):
        self.items: list[bytes] = []

    def add(self, b: bytes) -> int:
        self.items.append(b)
        return len(self.items) - 1

    def extend(self, bs) -> np.ndarray:
        first = len(self.items)
        self.items.extend(bs)
        return np.arange(first, len(self.items), dtype=np.int64)

    def render(self, ids: np.ndarray, limit: int | None = None) -> bytes:
        """The concatenation of the items `ids`, cut at `limit` bytes."""
        flat = np.frombuffer(b"".join(self.items), dtype=np.uint8)
        lens = np.fromiter((len(b) for b in self.items), dtype=np.int64,
                           count=len(self.items))
        offs = np.cumsum(lens) - lens
        parts = []
        total = 0
        step = 1 << 20
        for a in range(0, len(ids), step):
            sel = ids[a:a + step]
            ln = lens[sel]
            n = int(ln.sum())
            dst = np.cumsum(ln) - ln
            src = np.repeat(offs[sel] - dst, ln) + np.arange(n, dtype=np.int64)
            parts.append(flat[src].tobytes())
            total += n
            if limit is not None and total >= limit:
                break
        out = b"".join(parts)
        return out if limit is None else out[:limit]
