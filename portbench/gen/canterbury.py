"""Canterbury-corpus-like objects, replayed in a seed-shuffled order, each
object encoded as its own call.

The mix's ``objects`` list the corpus's files as ``[name, bytes, kind]``:
each object is made at its file's own size in its file's kind (English
text, HTML, C source, Lisp, spreadsheet, fax bitmap, executable, man
page), the same list for every seed.  The bytes of each object come from
the seed; a pass is every object once in a seed-drawn order, and every
pass has its own order.
"""

from __future__ import annotations

import hashlib

import numpy as np

import rng
from text import Table, vocabulary

KINDS = ("text", "html", "c", "lisp", "xls", "fax", "exe", "man")

C_WORDS = ("int char if for return struct static void while else break case "
           "switch unsigned long sizeof NULL const define include extern "
           "goto register double float typedef default continue").split()
LISP_WORDS = ("defun setq let cond car cdr cons lambda if and or not null "
              "eq equal list append progn quote mapcar length nth t nil "
              "defvar print").split()

# per text kind: (separators, their weights, leading bytes)
SEPS = {
    "text": ([" ", ", ", ". ", "\n", "\n\n", "; ", "\" ", " \"", "! ", "? "],
             [700, 60, 60, 110, 10, 10, 12, 12, 4, 4], ""),
    "html": ([" ", "\n", "<p>", "</p>\n", "<a href=\"", "\">", "</a> ",
              "<b>", "</b> ", "<li>", "</li>\n", "<td>", "</td>", "<br>\n",
              "<font size=\"-1\">", "</font>"],
             [500, 60, 20, 20, 25, 25, 25, 10, 10, 20, 20, 25, 25, 15, 5, 5],
             "<!DOCTYPE HTML PUBLIC \"-//W3C//DTD HTML 3.2//EN\">\n<html>\n"
             "<head>\n<title>Canterbury</title>\n</head>\n<body>\n"),
    "c": ([" ", "(", ")", ";\n\t", " = ", " == ", "->", ", ", "[", "]",
           "++", " + ", " *", "{\n\t", "}\n", ";\n\t\t", "\n/* ", " */\n",
           " != ", " < ", "_", "0", "1"],
          [220, 70, 70, 70, 40, 10, 25, 30, 12, 12, 8, 10, 10, 15, 15, 30,
           4, 4, 5, 8, 40, 10, 10],
          "#include <stdio.h>\n#include <stdlib.h>\n\n"),
    "lisp": ([" ", "(", ")", "\n  ", "\n    ", "))\n", ")))\n\n", " '", "-",
              " ; ", "\n;; "],
             [300, 120, 80, 60, 40, 30, 10, 10, 60, 3, 3], ";;; grammar\n"),
    "man": ([" ", "\n", "\n.B ", "\n.I ", "\n.TP\n", "\n.PP\n", "\n.SH ",
             " \\fB", "\\fR ", "\\-", ", ", ". "],
            [600, 80, 20, 15, 10, 8, 3, 10, 10, 10, 30, 30],
            ".TH XARGS 1L \\\" -*- nroff -*-\n.SH NAME\n"),
}


class Source:
    """The mix's inputs for one seed: ``item(i)`` is the i-th object of the
    replay."""

    def __init__(self, seed: int, params: dict):
        self.seed = seed
        self.p = params
        self.sizes_list = [n for _, n, _ in params["objects"]]
        self.pass_len = len(self.sizes_list)
        r = rng.py(rng.key(seed, 1))
        self.words = vocabulary(r, params["vocabulary"])
        self.objects = [self._object(k, n, kind)
                        for k, (_, n, kind) in enumerate(params["objects"])]

    def _object(self, k: int, n: int, kind: str) -> bytes:
        if kind not in KINDS:
            raise ValueError(f"unknown content kind {kind!r}")
        key = rng.key(self.seed, 5, k)
        if kind in SEPS:
            return self._text(kind, key, n)
        return getattr(self, "_" + kind)(key, n)

    def _text(self, kind: str, key: int, n: int) -> bytes:
        seps, weights, head = SEPS[kind]
        words = self.words
        if kind == "c":
            words = [w.encode() for w in C_WORDS] + words
        elif kind == "lisp":
            words = [w.encode() for w in LISP_WORDS] + words
        t = Table()
        w_ids = t.extend(words)
        s_ids = t.extend(s.encode() for s in seps)
        m = n // 4 + 64
        z = rng.u64(key, m)
        w = w_ids[rng.pick(rng.field(z, 0, 20), 20, rng.zipf_weights(len(words)))]
        s = s_ids[rng.pick(rng.field(z, 20, 12), 12, weights)]
        ids = np.stack([w, s], axis=1).reshape(-1)
        out = head.encode() + t.render(ids, n)
        while len(out) < n:  # short draws: extend from the next stream
            key = rng.key(key, 1)
            out += self._text(kind, key, n - len(out))
        return out[:n]

    def _xls(self, key: int, n: int) -> bytes:
        """BIFF-like records: NUMBER cells (row, column, format, a double
        from a small set of values) in row order, with LABEL records."""
        m = n // 18 + 8
        z = rng.u64(key, m)
        row = np.arange(m, dtype=np.int64) // 12
        col = np.arange(m, dtype=np.int64) % 12
        val = rng.scaled(rng.field(z, 0, 16), 16, 400).astype("<f8")
        val = np.where(rng.field(z, 16, 4) < 3, 0.0, val * 0.25)
        rec = np.zeros((m, 18), dtype=np.uint8)
        rec[:, 0:4] = np.frombuffer(b"\x03\x02\x0e\x00", np.uint8)
        rec[:, 4:6] = row.astype("<u2").view(np.uint8).reshape(-1, 2)
        rec[:, 6:8] = col.astype("<u2").view(np.uint8).reshape(-1, 2)
        rec[:, 8] = 0x0F + rng.field(z, 20, 2).astype(np.uint8)
        rec[:, 10:18] = val.astype("<f8").view(np.uint8).reshape(-1, 8)
        return rec.tobytes()[:n]

    def _fax(self, key: int, n: int) -> bytes:
        """A 1728-pixel-wide bitmap, 216 bytes a row: mostly white rows and
        lines of glyph-like byte patterns."""
        rows = n // 216 + 1
        z = rng.u64(key, rows * 216)
        ink = (rng.field(z[:rows * 27], 0, 8) < 40).reshape(rows, 27)  # 8-byte cells
        line = (np.arange(rows) // 24) % 3 != 2  # text lines, then gaps
        glyph = rng.field(z, 8, 8).astype(np.uint8).reshape(rows, 216)
        mask = np.repeat(ink & line[:, None], 8, axis=1)
        img = np.where(mask, glyph & np.uint8(0x7E), 0).astype(np.uint8)
        return img.tobytes()[:n]

    def _exe(self, key: int, n: int) -> bytes:
        """Instruction words from a Zipf-weighted set, some with random
        immediates, then a string table."""
        m = n // 4 + 1
        z = rng.u64(key, m)
        ops = rng.u64(rng.key(key, 1), 4096) & np.uint64(0xFFFFE000)
        word = ops[rng.pick(rng.field(z, 0, 20), 20, rng.zipf_weights(4096))]
        imm = np.where(rng.field(z, 20, 3) == 0, rng.field(z, 23, 13), 0)
        code = (word | imm).astype(">u4").tobytes()
        cut = n * 4 // 5
        strings = b"\0".join(self.words[:2000])
        return (code[:cut] + strings * (n // len(strings) + 1))[:n]

    def sizes(self) -> list[int]:
        return list(self.sizes_list)

    def order(self, j: int) -> list[int]:
        """Pass j's order of the objects."""
        z = rng.u64(rng.key(self.seed, 6, j), self.pass_len)
        return [int(i) for i in np.argsort(z, kind="stable")]

    def item(self, i: int) -> bytes:
        j, r = divmod(i, self.pass_len)
        return self.objects[self.order(j)[r]]

    def warmup(self, n: int) -> bytes:
        """`n` bytes for warming up a shape: a prefix of the first object of
        at least that size."""
        return next(o for o in self.objects if len(o) >= n)[:n]

    def digest(self) -> str:
        h = hashlib.sha256()
        for o in self.objects:
            h.update(o)
        return h.hexdigest()[:16]


def make(seed: int, params: dict) -> Source:
    return Source(seed, params)
