"""enwik8-like files: Wikipedia-dump markup around Zipf-distributed words.

The pattern is ``bench.py``'s ``make_corpus`` (XML page and revision
tags, ``[[links]]``, ``{{templates}}``, ``&lt;ref&gt;``, ``==`` headings,
repeated infobox templates), rewritten on ``rng``'s machine-independent
draws.  A pool of ``pool_bytes`` is made once from the seed; file ``i`` is
``file_bytes`` long and is cut from pool slices of ``slice_min`` ..
``slice_max`` bytes at seed-drawn, unaligned offsets, so that no two
segments are byte-identical.
"""

from __future__ import annotations

import hashlib

import numpy as np

import rng
from text import Table, vocabulary

MONTHS = ("January February March April May June July August September "
          "October November December").split()


def _pool(seed: int, p: dict) -> bytes:
    r = rng.py(rng.key(seed, 1))
    words = vocabulary(r, p["vocabulary"])
    v = len(words)
    t = Table()
    low = t.extend(words)
    cap = t.extend(w[:1].upper() + w[1:] for w in words)

    def phrase(k):
        return b" ".join(words[min(int(r.paretovariate(1.2)) * 3 + r.randrange(40), v - 1)]
                         for _ in range(k))

    def title():
        return b" ".join(w[:1].upper() + w[1:] for w in phrase(1 + r.randrange(3)).split())

    # pieces: (prefix, suffix) decorations and separators
    none = t.add(b"")
    deco = [(none, none), (t.add(b"[["), t.add(b"]]")), (t.add(b"'''"), t.add(b"'''")),
            (t.add(b"''"), t.add(b"''")), (t.add(b"[[Category:"), t.add(b"]]\n"))]
    deco_w = [880, 80, 12, 20, 8]
    seps = t.extend([b" ", b", ", b". ", b".\n\n", b"\n* ", b" (", b") ", b"; ", b" - "])
    seps_w = [800, 60, 60, 30, 15, 8, 8, 10, 9]
    para = 3  # index of the paragraph break in seps
    n_pages, n_tpl, n_ref, n_head = (p["pages"], p["templates"], p["refs"],
                                     p["headings"])
    pages = []
    for _ in range(n_pages):
        pages.append((
            "  </text>\n    </revision>\n  </page>\n  <page>\n    <title>%s</title>\n"
            "    <id>%d</id>\n    <revision>\n      <id>%d</id>\n"
            "      <timestamp>200%d-%02d-%02dT%02d:%02d:%02dZ</timestamp>\n"
            "      <contributor>\n        <username>%s</username>\n"
            "        <id>%d</id>\n      </contributor>\n"
            "      <comment>%s</comment>\n      <text xml:space=\"preserve\">"
            % (title().decode(), r.randrange(1, 300000), r.randrange(1, 40000000),
               r.randrange(2, 7), r.randrange(1, 13), r.randrange(1, 29),
               r.randrange(24), r.randrange(60), r.randrange(60),
               title().decode(), r.randrange(1, 900000), phrase(r.randrange(1, 6)).decode())
        ).encode())
    page_ids = t.extend(pages)
    tpls = []
    for j in range(n_tpl):  # the same row counts and lengths for every seed
        rows = "".join("| %s = %s\n" % (phrase(1).decode(), phrase(1 + (j + q) % 3).decode())
                       for q in range(3 + j % 11))
        tpls.append(("\n{{Infobox %s\n%s}}\n" % (phrase(1).decode(), rows)).encode())
    tpl_ids = t.extend(tpls)
    refs = t.extend(
        ("&lt;ref&gt;{{cite web|url=http://www.%s.com/%s|title=%s|accessdate=%d %s "
         "200%d}}&lt;/ref&gt;" % (words[r.randrange(v)].decode(), words[r.randrange(v)].decode(),
                                 title().decode(), r.randrange(1, 29), MONTHS[r.randrange(12)],
                                 r.randrange(2, 7))).encode()
        for _ in range(n_ref))
    heads = t.extend(("\n== %s ==\n" % title().decode()).encode() for _ in range(n_head))

    n = p["pool_bytes"] // 6 + 1024
    k = rng.key(seed, 2)
    z = rng.u64(rng.key(k, 1), n)
    word = low[rng.pick(rng.field(z, 0, 22), 22, rng.zipf_weights(v))]
    word = np.where(rng.field(z, 22, 10) < 92, cap[word - low[0]], word)
    d = rng.pick(rng.field(z, 32, 10), 10, deco_w)
    pre = np.array([a for a, _ in deco])[d]
    suf = np.array([b for _, b in deco])[d]
    si = rng.pick(rng.field(z, 42, 10), 10, seps_w)
    sep = seps[si]
    u = rng.scaled(rng.field(z, 52, 12), 12, 4096)
    del z
    z = rng.u64(rng.key(k, 3), n)
    ref = np.where(u < 10, refs[rng.scaled(rng.field(z, 16, 16), 16, n_ref)], -1)
    brk = si == para
    special = np.full(n, -1, dtype=np.int64)
    tz = rng.pick(rng.field(z, 32, 16), 16, rng.zipf_weights(n_tpl, 40))
    special = np.where(brk & (u < 400), tpl_ids[tz], special)
    special = np.where(brk & (u >= 400) & (u < 1600),
                       heads[rng.scaled(rng.field(z, 48, 16), 16, n_head)], special)
    special = np.where(rng.field(z, 0, 16) < 66,
                       page_ids[rng.scaled(rng.field(z, 48, 16), 16, n_pages)], special)
    del z
    ids = np.stack([pre, word, suf, ref, sep, special], axis=1).reshape(-1)
    ids = ids[ids >= 0]
    head = t.add(b"<mediawiki xmlns=\"http://www.mediawiki.org/xml/export-0.3/\">\n"
                 b"  <page>\n    <text xml:space=\"preserve\">")
    return t.render(np.concatenate([[head], ids]), p["pool_bytes"])


class Source:
    """The mix's inputs for one seed: ``item(i)`` is the i-th file."""

    def __init__(self, seed: int, params: dict):
        self.seed = seed
        self.p = params
        self.pool = _pool(seed, params)
        self.view = memoryview(self.pool)
        self.pass_len = 1

    def sizes(self) -> list[int]:
        return [self.p["file_bytes"]]

    def item(self, i: int) -> bytes:
        """File i: the pool read circularly from a seed-drawn offset in
        slices of seed-drawn lengths, each followed by a seed-drawn skip
        of 1 to 4096 bytes, so that no pool byte recurs within a pool's
        length of the file and no two segments are byte-identical."""
        n, lo, hi = self.p["file_bytes"], self.p["slice_min"], self.p["slice_max"]
        k = rng.key(self.seed, 3, i)
        m = n // lo + 2
        lens = (lo + rng.below(rng.key(k, 1), m, hi - lo + 1)).tolist()
        skips = (1 + rng.below(rng.key(k, 2), m, 4096)).tolist()
        size = len(self.pool)
        off = int(rng.below(rng.key(k, 3), 1, size)[0])
        parts, total = [], 0
        for ln, skip in zip(lens, skips):
            ln = min(ln, n - total, size - off)
            parts.append(self.view[off:off + ln])
            total += ln
            if total == n:
                break
            off = (off + ln + skip) % size
        return b"".join(parts)

    def warmup(self, n: int) -> bytes:
        """`n` bytes for warming up a shape, from its own stream."""
        off = int(rng.below(rng.key(self.seed, 4), 1, len(self.pool) - n)[0])
        return bytes(self.view[off:off + n])

    def digest(self) -> str:
        return hashlib.sha256(self.pool).hexdigest()[:16]


def make(seed: int, params: dict) -> Source:
    return Source(seed, params)
