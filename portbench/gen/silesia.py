"""Silesia-corpus-like files, replayed in a seed-shuffled order, each file
encoded as its own call.

The mix's ``files`` list the corpus's 12 files as ``[name, bytes, kind]``
(Deorowicz 2003): each file is made at its own size in its own kind, the
same list for every seed.  The bytes come from the seed; a pass is every
file once in a seed-drawn order, and every pass has its own order (the
replay, ``item``, ``order``, ``warmup`` and ``digest`` are
``canterbury.Source``'s, as are the English text, HTML, C and executable
makers).  Integer arithmetic only (``rng``), so the bytes do not depend on
the numpy release; the few floats stored (star positions, database
columns) are integers times a constant, which IEEE arithmetic rounds alike
everywhere.

The kinds follow the files' published descriptions; what departs from the
real files:

- ``text`` (dickens, collected works of Charles Dickens): English prose
  from a Zipf vocabulary; no chapter structure.
- ``tar-exe`` (mozilla, a tar of the Mozilla 1.0 distribution for Linux):
  ustar members with valid header checksums, 60% executables (code words
  and a string table each), 25% HTML and 15% script-like C text; member
  sizes log-uniform, zero-padded to the file's size as tar pads to its
  10 KiB records.
- ``mr`` and ``x-ray`` (a DICOM magnetic resonance image; an X-ray
  picture): a header, then little-endian 16-bit samples of a smooth 2-D
  field (integer paraboloid bumps and ellipses) plus uniform noise; mr in
  512 x 512 slices of a head-like ellipse on a dark background, x-ray one
  2048-wide frame of 12 significant bits.  The layout of each image is
  the same for every seed (one picture each in the corpus) and the noise
  comes from the seed.  The DICOM header holds a few tags, not the full
  set.
- ``sdf`` (nci, a chemical database of structures): SDF records, a name,
  program and count line, 2-D atom lines of fixed-column coordinates
  (a random walk of 1.5 A bonds in 30-degree steps, jittered), bond lines,
  ``M  END``, one data field and ``$$$$``; no real chemistry.
- ``x86`` (ooffice, a dll of OpenOffice.org 1.01): a PE-like header, x86
  instructions drawn Zipf from a table of 16384 concrete instructions
  (so call displacements repeat more than in real code), mangled export
  names, UTF-16 resource strings and a PE relocation table.
- ``rows`` (osdb, a MySQL table of the Open Source Database Benchmark):
  fixed 175-byte MyISAM-like rows (flag byte, ascending int32 key, three
  int32, float, double, an ASCII decimal, a date, space-padded code, name
  and address); the last row is cut at the file's size.
- ``pdf-latin2`` (reymont, Reymont's "Chlopi" as PDF): Polish-like words
  in ISO 8859-2 in uncompressed PDF text streams, one page object and
  content stream a page, an xref table whose offsets are evenly spaced,
  not the objects' own.
- ``tar-c`` (samba, a tar of the Samba 2.2.3a sources): ustar members,
  80% C files each opening with the same licence comment, 10% text and
  10% HTML documents.
- ``stars`` (sao, the SAO star catalogue): a 28-byte header, then 28-byte
  records (right ascension and declination as doubles in radians, a
  2-letter spectral type, magnitude x 100 as int16, proper motions as
  float32) sorted by right ascension; uniform over the sphere's
  coordinates, not its area.
- ``dict-html`` (webster, the 1913 Webster dictionary in HTML): entries in
  alphabetical order of the vocabulary, each a headword, pronunciation,
  part of speech, etymology and definitions in the Gutenberg edition's
  tags; a vocabulary shorter than the entries repeats its headwords.
- ``tar-xml`` (xml, a tar of collected XML files): ustar members, each an
  XML declaration and doctype, then elements around English words (the
  tags are drawn, not nested).
"""

from __future__ import annotations

import bisect
import itertools

import numpy as np

import canterbury
import rng
from text import Table, vocabulary

KINDS = ("text", "tar-exe", "mr", "sdf", "x86", "rows", "pdf-latin2", "tar-c",
         "stars", "dict-html", "tar-xml", "x-ray")

LICENCE = (b"/* \n   Unix SMB/Netbios implementation.\n   Version 2.2\n   "
           b"%s\n   Copyright (C) Andrew Tridgell 1992-2001\n   \n"
           b"   This program is free software; you can redistribute it and/or "
           b"modify\n   it under the terms of the GNU General Public License as "
           b"published by\n   the Free Software Foundation; either version 2 of "
           b"the License, or\n   (at your option) any later version.\n   \n"
           b"   This program is distributed in the hope that it will be useful,"
           b"\n   but WITHOUT ANY WARRANTY; without even the implied warranty of"
           b"\n   MERCHANTABILITY or FITNESS FOR A PARTICULAR PURPOSE.  See the\n"
           b"   GNU General Public License for more details.\n*/\n\n"
           b"#include \"includes.h\"\n\n")
XML_HEAD = (b"<?xml version=\"1.0\" encoding=\"ISO-8859-1\"?>\n"
            b"<!-- %s -->\n<!DOCTYPE catalog SYSTEM \"catalog.dtd\">\n<catalog>\n")
XML_SEPS = ([" ", "\n  <item id=\"", "\">", "</item>", "\n    <name>", "</name>",
             "<value>", "</value>", "\n    <description>", "</description>\n",
             ", ", ". ", " type=\"", "\"/>\n", "\n  <entry key=\"", "</entry>\n"],
            [500, 25, 50, 25, 30, 30, 30, 30, 15, 15, 40, 30, 15, 15, 20, 20])

# (opcode bytes, operand kind, weight): common 32-bit x86 instructions
X86 = [
    (b"\x55", "", 40), (b"\x8b\xec", "", 40), (b"\x5d", "", 30), (b"\xc3", "", 30),
    (b"\xc2", "i16", 8), (b"\x83\xec", "i8", 20), (b"\x83\xc4", "i8", 25),
    (b"\x8b\x45", "d8", 60), (b"\x8b\x4d", "d8", 50), (b"\x8b\x55", "d8", 30),
    (b"\x89\x45", "d8", 40), (b"\x8d\x4d", "d8", 30), (b"\x8b\x46", "o8", 40),
    (b"\x8b\x4e", "o8", 30), (b"\x89\x46", "o8", 25), (b"\xe8", "rel32", 60),
    (b"\xff\x15", "abs32", 30), (b"\xe9", "rel32", 10), (b"\xeb", "r8", 20),
    (b"\x74", "r8", 30), (b"\x75", "r8", 30), (b"\x0f\x84", "rel32", 10),
    (b"\x85\xc0", "", 40), (b"\x33\xc0", "", 25), (b"\x50", "", 30),
    (b"\x51", "", 20), (b"\x52", "", 10), (b"\x53", "", 10), (b"\x56", "", 30),
    (b"\x57", "", 20), (b"\x5e", "", 25), (b"\x5f", "", 20), (b"\x5b", "", 10),
    (b"\x59", "", 10), (b"\x8b\xf1", "", 25), (b"\x8b\xce", "", 25),
    (b"\x8b\xc6", "", 15), (b"\x68", "abs32", 15), (b"\x6a", "i8", 25),
    (b"\xb8", "i32", 10), (b"\x83\xf8", "i8", 10), (b"\x3b\xc1", "", 8),
    (b"\xc7\x45", "d8i32", 10), (b"\xa1", "abs32", 10), (b"\x8b\x01", "", 10),
    (b"\xff\x50", "o8", 15), (b"\xff\x52", "o8", 10), (b"\xc9", "", 8),
    (b"\x90", "", 5), (b"\xcc\xcc\xcc\xcc", "", 6),
    (b"\x64\xa1\x00\x00\x00\x00", "", 4),
]

# Polish syllables in ISO 8859-2 (a-ogonek b1, c-acute e6, e-ogonek ea,
# l-stroke b3, n-acute f1, o-acute f3, s-acute b6, z-acute bc, z-dot bf)
PL_COMMON = (b"i w na z nie si\xea \xbfe do jak to a o co za tak po jego ju\xbf "
             b"od ja by ale go jej ten ich mu pod jeszcze tylko tam by\xb3 "
             b"by\xb3a przez ani bo gdy ju\xbf wszystko jako kiedy").split()
PL_ONSETS = (b"", b"", b"w", b"p", b"pr", b"k", b"n", b"m", b"s", b"sz", b"cz",
             b"rz", b"dz", b"t", b"d", b"g", b"ch", b"z", b"\xbf", b"\xb6",
             b"c", b"l", b"\xb3", b"j", b"r", b"st", b"zw", b"wsz", b"pi",
             b"bi", b"mi", b"ni", b"dr", b"gr", b"kr", b"tr", b"\xe6")
PL_VOWELS = (b"a", b"e", b"i", b"o", b"u", b"y", b"a", b"e", b"o", b"\xb1",
             b"\xea", b"\xf3", b"ie", b"ia", b"io", b"y")
PL_CODAS = (b"", b"", b"", b"", b"n", b"m", b"\xb3", b"k", b"j", b"\xe6",
            b"\xf1", b"s", b"sz", b"ch", b"st", b"\xb6\xe6", b"\xbf", b"r",
            b"wa", b"ny", b"ska", b"li")

# the images' layout (mr's inner structures, x-ray's bumps) is the same for
# every seed, as the corpus holds one picture of each; only the noise comes
# from the seed, so that an image's shape buckets do not change with it
LAYOUT = 0x53494C45

SPECTRAL = (b"B9", b"A0", b"A2", b"A5", b"F0", b"F5", b"F8", b"G0", b"G5",
            b"G8", b"K0", b"K2", b"K5", b"M0", b"M3", b"B5")
SPECTRAL_W = (4, 12, 6, 5, 7, 9, 6, 8, 9, 7, 14, 9, 8, 4, 2, 3)
ELEMENTS = (b"C  ", b"N  ", b"O  ", b"S  ", b"Cl ", b"F  ", b"P  ", b"Br ")
ELEMENTS_W = (620, 110, 170, 30, 30, 20, 10, 10)
# 1.5 A steps in 30-degree directions, in 1/10000 A
STEPS = ((15000, 0), (12990, 7500), (7500, 12990), (0, 15000), (-7500, 12990),
         (-12990, 7500), (-15000, 0), (-12990, -7500), (-7500, -12990),
         (0, -15000), (7500, -12990), (12990, -7500))


def weighted_index(r, weights) -> int:
    """An index drawn with integer weights from the Python generator `r`."""
    cum = list(itertools.accumulate(weights))
    return bisect.bisect_right(cum, r.randrange(cum[-1]))


def tokens(key: int, n: int, words, seps, weights, head: bytes = b"",
           heads=None) -> bytes:
    """`n` bytes: `head`, then words drawn Zipf from `words` alternating with
    separators drawn with `weights`.  With `heads`, the last separator is a
    numbered break: its j-th occurrence is replaced by ``heads[j]`` (cycling),
    so that records come in the order of `heads`."""
    t = Table()
    w_ids = t.extend(words)
    s_ids = t.extend(x.encode() for x in seps)
    h_ids = t.extend(heads) if heads else None
    out, at = [head], len(head)
    breaks = 0
    while at < n:
        m = (n - at) // 4 + 64
        z = rng.u64(key, m)
        w = w_ids[rng.pick(rng.field(z, 0, 20), 20, rng.zipf_weights(len(words)))]
        s = s_ids[rng.pick(rng.field(z, 20, 12), 12, weights)]
        if heads:
            brk = s == s_ids[-1]
            j = breaks + np.cumsum(brk) - 1
            s = np.where(brk, h_ids[j % len(heads)], s)
            breaks += int(brk.sum())
        part = t.render(np.stack([w, s], axis=1).reshape(-1), n - at)
        out.append(part)
        at += len(part)
        key = rng.key(key, 1)
    return b"".join(out)[:n]


def tar_header(name: bytes, size: int, mtime: int) -> bytes:
    """A POSIX ustar header for a regular file, with its checksum."""
    h = bytearray(512)
    h[0:len(name[:100])] = name[:100]
    h[100:108] = b"0000644\0"
    h[108:116] = b"0001750\0"
    h[116:124] = b"0000144\0"
    h[124:136] = b"%011o\0" % size
    h[136:148] = b"%011o\0" % mtime
    h[148:156] = b" " * 8
    h[156] = ord("0")
    h[257:265] = b"ustar\x0000"
    h[265:269] = b"user"
    h[297:302] = b"users"
    h[148:156] = b"%06o\0 " % sum(h)
    return bytes(h)


def log_size(r, lo: int, hi: int) -> int:
    """A size between about `lo` and `hi`, log-uniform in integers."""
    top = max(1, (hi // lo).bit_length() - 1)
    return max(1, ((256 + r.randrange(256)) * lo << r.randrange(top)) >> 8)


class Source(canterbury.Source):
    """The mix's inputs for one seed: ``item(i)`` is the i-th file of the
    replay."""

    def __init__(self, seed: int, params: dict):
        self.seed = seed
        self.p = params
        self.sizes_list = [n for _, n, _ in params["files"]]
        self.pass_len = len(self.sizes_list)
        r = rng.py(rng.key(seed, 1))
        self.words = vocabulary(r, params["vocabulary"])
        self.objects = [self._file(k, n, kind)
                        for k, (_, n, kind) in enumerate(params["files"])]

    def _file(self, k: int, n: int, kind: str) -> bytes:
        if kind not in KINDS:
            raise ValueError(f"unknown content kind {kind!r}")
        key = rng.key(self.seed, 7, k)
        if kind == "text":
            out = self._text("text", key, n)
        else:
            out = getattr(self, "_" + kind.replace("-", "_"))(key, n)
        assert len(out) == n, (kind, len(out), n)
        return out

    # archives

    def _tar(self, key: int, n: int, root: bytes, members) -> bytes:
        """A ustar archive of exactly `n` bytes, then zeros.  `members` is a
        list of (weight, lo, hi, suffix, head, make): a member of that kind
        is ``head`` (``%s`` its file's base name) and its next bytes of the
        stream ``make(key, total)``, or, with ``head`` None, the whole
        ``make(key, size)``."""
        r = rng.py(key)
        weights = [m[0] for m in members]
        plan = []  # (kind, name, size)
        at = 0
        dirs = [root + b"/" + w for w in self.words[100:116]]
        while True:
            cap = (n - at - 512 - 1024) // 512 * 512
            if cap <= 0:
                break
            i = weighted_index(r, weights)
            _, lo, hi, suffix, _, _ = members[i]
            size = min(log_size(r, lo, hi), cap)
            name = (dirs[r.randrange(len(dirs))] + b"/"
                    + self.words[r.randrange(200, len(self.words))] + suffix)
            plan.append((i, name, size))
            at += 512 + -(-size // 512) * 512
        streams = {}
        for i, (_, _, _, _, head, make) in enumerate(members):
            if head is not None:
                total = sum(size for j, _, size in plan if j == i)
                streams[i] = [make(rng.key(key, 1, i), total), 0]
        out = []
        for j, (i, name, size) in enumerate(plan):
            head = members[i][4]
            if head is None:
                body = members[i][5](rng.key(key, 2, j), size)
            else:
                stream = streams[i]
                h = head % name.rsplit(b"/", 1)[-1] if b"%s" in head else head
                body = (h + stream[0][stream[1]:stream[1] + size])[:size]
                stream[1] += size - len(h)
            out += [tar_header(name, size, 1022000000 + 97 * j), body,
                    bytes(-size % 512)]
        data = b"".join(out)
        return data + bytes(n - len(data))

    def _text_stream(self, kind: str):
        return lambda key, total: self._text(kind, key, total)

    def _tar_exe(self, key: int, n: int) -> bytes:
        return self._tar(key, n, b"mozilla", [
            (3, 65536, 4 << 20, b".so", None, self._exe),
            (5, 2048, 65536, b".html", b"", self._text_stream("html")),
            (4, 2048, 65536, b".js", b"", self._text_stream("c")),
        ])

    def _tar_c(self, key: int, n: int) -> bytes:
        return self._tar(key, n, b"samba-2.2.3a/source", [
            (16, 2048, 131072, b".c", LICENCE, self._text_stream("c")),
            (2, 1024, 65536, b".txt", b"", self._text_stream("text")),
            (2, 2048, 65536, b".html", b"", self._text_stream("html")),
        ])

    def _tar_xml(self, key: int, n: int) -> bytes:
        return self._tar(key, n, b"xml", [
            (1, 1024, 65536, b".xml", XML_HEAD,
             lambda k, total: tokens(k, total, self.words, *XML_SEPS))])

    # images

    def _mr(self, key: int, n: int) -> bytes:
        """A DICOM-like header, then 512 x 512 slices of a head-like ellipse
        with inner structures, on a dark background with noise."""
        head = bytearray(132)
        head[128:132] = b"DICM"
        for tag in (b"\x08\x00\x60\x00CS\x02\x00MR", b"\x10\x00\x10\x00PN\x08\x00ANONYMUS",
                    b"\x28\x00\x10\x00US\x02\x00\x00\x02", b"\x28\x00\x11\x00US\x02\x00\x00\x02",
                    b"\x28\x00\x00\x01US\x02\x00\x10\x00", b"\x28\x00\x01\x01US\x02\x00\x0c\x00"):
            head += tag
        head += b"\xe0\x7f\x10\x00OW\x00\x00" + ((n - len(head) - 12) & ~1).to_bytes(4, "little")
        count = (n - len(head)) // 2
        side = 512
        yy, xx = np.divmod(np.arange(side * side, dtype=np.int64), side)
        z = rng.u64(rng.key(LAYOUT, 1), 4).tolist()
        slices = []
        for s in range(-(-count // (side * side))):
            k = rng.key(key, 2, s)
            depth = 2 * s - (count // (side * side))  # distance from the middle slice
            a = 200 - depth * depth // 4
            b = 160 - depth * depth // 5
            v = self._ellipse(xx, yy, 256, 256, max(a, 8), max(b, 8), 900)
            for j in range(4):  # inner structures
                cx, cy = 160 + z[j] % 190, 170 + (z[j] >> 16) % 170
                v += self._ellipse(xx, yy, cx, cy, 20 + (z[j] >> 32) % 40,
                                   15 + (z[j] >> 40) % 30, (z[j] >> 48) % 600 - 300)
            v = np.maximum(v, 0) + rng.below(k, side * side, 24)
            slices.append(v.astype("<u2"))
        img = np.concatenate(slices)[:count].tobytes()
        return (bytes(head) + img + bytes(2))[:n]

    @staticmethod
    def _ellipse(xx, yy, cx, cy, a, b, level):
        """`level` at the centre falling to a third at the rim of the
        ellipse with half-axes a, b; 0 outside (integer arithmetic)."""
        r2 = ((xx - cx) * b) ** 2 + ((yy - cy) * a) ** 2
        ab2 = (a * b) ** 2
        return np.where(r2 <= ab2, level - (2 * level * (r2 // (ab2 // 1024 + 1))) // 3072, 0)

    def _x_ray(self, key: int, n: int) -> bytes:
        """A 16-byte header (width, height, bits), then one 2048-wide frame
        of 12-bit samples: a bright field with darker paraboloid bumps
        (bones and soft tissue) and noise."""
        width = 2048
        count = (n - 16) // 2
        height = -(-count // width)
        head = (b"XRAY" + width.to_bytes(4, "little") + height.to_bytes(4, "little")
                + (12).to_bytes(4, "little"))
        z = rng.u64(rng.key(LAYOUT, 2), 16).tolist()
        bumps = [(v % width, (v >> 12) % max(height, 256), 200 + (v >> 24) % 600,
                  (v >> 40) % 900) for v in z]
        rows = []
        for r0 in range(0, height, 256):
            h = min(256, height - r0)
            yy, xx = np.divmod(np.arange(h * width, dtype=np.int64), width)
            yy += r0
            v = 3000 + (xx * 400) // width - (yy * 300) // max(height, 1)
            for cx, cy, rad, depth in bumps:
                d2 = (xx - cx) ** 2 + (yy - cy) ** 2
                v -= np.maximum(rad * rad - d2, 0) * depth // (rad * rad)
            v += rng.below(rng.key(key, 2, r0), h * width, 33) - 16
            rows.append(np.clip(v, 0, 4095).astype("<u2"))
        img = np.concatenate(rows)[:count].tobytes()
        return (head + img + bytes(2))[:n]

    # records

    def _sdf(self, key: int, n: int) -> bytes:
        """SDF molecule records until `n` bytes, the last one cut."""
        z = iter(rng.u64(key, n // 8 + 4096).tolist())
        cum_el = list(itertools.accumulate(ELEMENTS_W))
        out, size, mol = [], 0, 0
        while size < n:
            v = next(z)
            atoms, rings = 5 + v % 40, v >> 40 & 3
            nsc = 1000 + mol * 7 + (v >> 20) % 7
            lines = [b"%d\n  -ISIS-  0521021535 2D\n\n" % nsc,
                     b"%3d%3d  0  0  0  0  0  0  0  0999 V2000\n" % (atoms, atoms - 1 + rings)]
            x = y = 0
            for _ in range(atoms):
                v = next(z)
                dx, dy = STEPS[v % 12]
                x += dx + (v >> 16) % 1001 - 500
                y += dy + (v >> 26) % 1001 - 500
                el = bisect.bisect_right(cum_el, (v >> 8) % cum_el[-1])
                lines.append(b"%s%s    0.0000 %s 0  0  0  0  0  0  0  0  0  0  0  0\n"
                             % (_fixed(x), _fixed(y), ELEMENTS[el]))
            for a in range(1, atoms):
                v = next(z)
                kind = 1 if v % 10 < 8 else (2 if v % 10 < 9 else 3)
                lines.append(b"%3d%3d%3d  0  0  0  0\n" % (a, a + 1, kind))
            for _ in range(rings):
                v = next(z)
                lines.append(b"%3d%3d  1  0  0  0  0\n" % (1 + v % atoms, 1 + (v >> 8) % atoms))
            lines.append(b"M  END\n> <NSC>\n%d\n\n$$$$\n" % nsc)
            rec = b"".join(lines)
            out.append(rec)
            size += len(rec)
            mol += 1
        return b"".join(out)[:n]

    def _rows(self, key: int, n: int) -> bytes:
        """175-byte MyISAM-like rows: flag, key, three int32, a float, a
        double, a 20-byte ASCII decimal, a date, code, name, address."""
        width = 175
        rows = -(-n // width)
        z = rng.u64(key, rows)
        z2 = rng.u64(rng.key(key, 1), rows)
        r = rng.py(rng.key(key, 2))
        words = self.words
        names = np.frombuffer(b"".join(
            (words[r.randrange(len(words))].capitalize() + b" "
             + words[r.randrange(len(words))].capitalize()).ljust(20)[:20]
            for _ in range(4096)), np.uint8).reshape(4096, 20)
        addrs = np.frombuffer(b"".join(
            (b"%d " % r.randrange(1, 9999) + b" ".join(
                words[r.randrange(len(words))] for _ in range(2 + r.randrange(5)))
             ).ljust(80)[:80] for _ in range(4096)), np.uint8).reshape(4096, 80)
        codes = np.frombuffer(b"".join(
            bytes(65 + r.randrange(26) for _ in range(10)) for _ in range(4096)),
            np.uint8).reshape(4096, 10)
        dates = np.frombuffer(b"".join(
            b"%04d-%02d-%02d %02d:%02d:%02d " % (1990 + r.randrange(12), 1 + r.randrange(12),
                                                 1 + r.randrange(28), r.randrange(24),
                                                 r.randrange(60), r.randrange(60))
            for _ in range(4096)), np.uint8).reshape(4096, 20)
        m = np.zeros((rows, width), dtype=np.uint8)
        m[:, 0] = 0xFD
        m[:, 1:5] = np.arange(1, rows + 1, dtype="<i4").view(np.uint8).reshape(-1, 4)
        m[:, 5:9] = rng.scaled(rng.field(z, 0, 20), 20, 1000000).astype("<i4").view(
            np.uint8).reshape(-1, 4)
        m[:, 9:13] = (rng.scaled(rng.field(z, 20, 20), 20, 2000000) - 1000000).astype(
            "<i4").view(np.uint8).reshape(-1, 4)
        m[:, 13:17] = rng.scaled(rng.field(z, 40, 10), 10, 100).astype("<i4").view(
            np.uint8).reshape(-1, 4)
        cents = rng.scaled(rng.field(z2, 0, 24), 24, 100000000)
        m[:, 17:21] = (cents.astype("<f8") * 0.01).astype("<f4").view(np.uint8).reshape(-1, 4)
        m[:, 21:29] = (rng.scaled(rng.field(z2, 24, 24), 24, 10000000).astype("<f8")
                       * 0.001).view(np.uint8).reshape(-1, 8)
        table = rng.scaled(rng.field(rng.u64(rng.key(key, 3), 4096), 0, 24), 24, 100000000)
        dec = np.frombuffer(b"".join(b"%17d.%02d" % (c // 100, c % 100)
                                     for c in table.tolist()),
                            np.uint8).reshape(-1, 20)
        m[:, 29:49] = dec[rng.field(z, 0, 12).astype(np.int64)]
        m[:, 49:69] = dates[rng.field(z2, 48, 12).astype(np.int64)]
        m[:, 69:79] = codes[rng.field(z, 50, 12).astype(np.int64)]
        m[:, 79:99] = names[rng.field(z2, 0, 12).astype(np.int64)]
        m[:, 99:175] = addrs[rng.field(z2, 12, 12).astype(np.int64), :76]
        return m.tobytes()[:n]

    def _stars(self, key: int, n: int) -> bytes:
        """A 28-byte header (seven int32), then 28-byte star records sorted
        by right ascension."""
        count = (n - 28) // 28
        head = np.array([0, 1, count, 0, 1, 1, 28], dtype="<i4").tobytes()
        z = rng.u64(key, count)
        z2 = rng.u64(rng.key(key, 1), count)
        ra = np.cumsum(rng.scaled(rng.field(z, 0, 20), 20, 1 << 20))
        rec = np.zeros((count, 28), dtype=np.uint8)
        turn = 6.283185307179586 / (int(ra[-1]) + 1 if count else 1)
        rec[:, 0:8] = (ra.astype("<f8") * turn).view(np.uint8).reshape(-1, 8)
        dec = rng.scaled(rng.field(z, 20, 24), 24, 1 << 24) - (1 << 23)
        rec[:, 8:16] = (dec.astype("<f8") * (1.5707963267948966 / 8388608.0)).view(
            np.uint8).reshape(-1, 8)
        sp = np.frombuffer(b"".join(SPECTRAL), np.uint8).reshape(-1, 2)
        rec[:, 16:18] = sp[rng.pick(rng.field(z, 44, 12), 12, SPECTRAL_W)]
        mag = 200 + rng.scaled(rng.field(z2, 0, 16), 16, 900) + rng.scaled(
            rng.field(z2, 16, 8), 8, 100)
        rec[:, 18:20] = mag.astype("<i2").view(np.uint8).reshape(-1, 2)
        for c, lo in ((20, 24), (24, 40)):
            pm = rng.scaled(rng.field(z2, lo, 16), 16, 2000) - 1000
            rec[:, c:c + 4] = (pm.astype("<f8") * 1e-7).astype("<f4").view(
                np.uint8).reshape(-1, 4)
        return (head + rec.tobytes() + bytes(28))[:n]

    # text in containers

    def _x86(self, key: int, n: int) -> bytes:
        """A PE-like header, x86 code, export names, UTF-16 strings and a
        relocation table."""
        r = rng.py(rng.key(key, 1))
        head = bytearray(4096)
        head[0:2] = b"MZ"
        head[60:64] = (128).to_bytes(4, "little")
        head[64:103] = b"This program cannot be run in DOS mode."
        head[128:132] = b"PE\0\0"
        head[132:134] = b"\x4c\x01"
        for s, name in enumerate((b".text", b".rdata", b".data", b".rsrc", b".reloc")):
            head[376 + 40 * s:376 + 40 * s + len(name)] = name
        code_n = n * 64 // 100
        strs_n = n * 14 // 100
        wide_n = n * 8 // 100
        weights = [w for _, _, w in X86]
        insns = []
        for _ in range(16384):
            op, kind, _ = X86[weighted_index(r, weights)]
            v = r.getrandbits(32)
            insns.append(op + _operand(kind, v))
        t = Table()
        ids = t.extend(insns)
        z = rng.u64(rng.key(key, 2), code_n // 2 + 64)
        code = t.render(ids[rng.pick(rng.field(z, 0, 20), 20, rng.zipf_weights(len(insns)))],
                        code_n)
        w = self.words
        names = b"\0".join(b"?%s@%s@@QAEXPAV%s@@@Z" % (
            w[r.randrange(len(w))], w[r.randrange(len(w))].capitalize(),
            w[r.randrange(len(w))].capitalize()) for _ in range(strs_n // 30 + 2))
        wide = self._text("text", rng.key(key, 3), wide_n // 2 + 1)
        wide = np.frombuffer(wide, np.uint8).astype("<u2").tobytes()
        relocs = []
        size = 0
        reloc_n = n - len(head) - code_n - strs_n - wide_n
        page = 0
        while size < reloc_n:
            k = 16 + r.randrange(200)
            offs = np.sort(rng.below(rng.key(key, 4, page), k, 4096)) | 0x3000
            block = ((0x1000 * (page + 1)).to_bytes(4, "little")
                     + (8 + 2 * k).to_bytes(4, "little") + offs.astype("<u2").tobytes())
            relocs.append(block)
            size += len(block)
            page += 1
        out = (bytes(head) + code + names[:strs_n].ljust(strs_n, b"\0")
               + wide[:wide_n].ljust(wide_n, b"\0") + b"".join(relocs))
        return out[:n]

    def _pdf_latin2(self, key: int, n: int) -> bytes:
        """Polish text in ISO 8859-2 inside PDF page objects and content
        streams, then an xref table and trailer."""
        r = rng.py(rng.key(key, 1))
        words = list(PL_COMMON)
        seen = set(words)
        while len(words) < 12000:
            w = b"".join(PL_ONSETS[r.randrange(len(PL_ONSETS))]
                         + PL_VOWELS[r.randrange(len(PL_VOWELS))]
                         + PL_CODAS[r.randrange(len(PL_CODAS))]
                         for _ in range(1 + r.randrange(4)))
            if len(w) > 1 and w not in seen:
                seen.add(w)
                words.append(w)
        pages = n // 3000 + 1
        objs = 2 * pages + 6
        heads = [b") Tj\nET\nendstream\nendobj\n%d 0 obj\n<< /Type /Page /Parent 3 0 R "
                 b"/Resources 5 0 R /Contents %d 0 R /MediaBox [0 0 595 842] >>\nendobj\n"
                 b"%d 0 obj\n<< /Length %d >>\nstream\nBT\n/F1 11 Tf\n56 786 Td\n13 TL\n("
                 % (2 * j + 6, 2 * j + 7, 2 * j + 7, 2600 + (j * 37) % 800)
                 for j in range(pages)]
        head = (b"%PDF-1.2\n%\xe2\xe3\xcf\xd3\n1 0 obj\n<< /Type /Catalog /Pages 3 0 R >>\n"
                b"endobj\n5 0 obj\n<< /Font << /F1 4 0 R >> >>\nendobj\n4 0 obj\n"
                b"<< /Type /Font /Subtype /Type1 /BaseFont /Times-Roman "
                b"/Encoding /ISO-8859-2 >>\nendobj\n(")
        tail = (b") Tj\nET\nendstream\nendobj\nxref\n0 %d\n0000000000 65535 f \n" % objs
                + b"".join(b"%010d 00000 n \n" % (i * n // objs) for i in range(1, objs))
                + b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
                % (objs, n - 40))
        seps = [" ", ", ", ". ", ") Tj T*\n(", "? ", "! ", " -- ", "; ", ""]
        weights = [700, 60, 45, 95, 5, 5, 8, 6, 2]
        body = tokens(key, max(n - len(tail), 0), words, seps, weights, head=head,
                      heads=heads)
        return (body + tail)[:n]

    def _dict_html(self, key: int, n: int) -> bytes:
        """Dictionary entries in alphabetical order, in the Gutenberg
        Webster's tags."""
        r = rng.py(rng.key(key, 1))
        pos = (b"n.", b"v. t.", b"v. i.", b"a.", b"adv.", b"prep.", b"n. pl.")
        heads = []
        for w in sorted(self.words[60:]):
            cut = 1 + r.randrange(max(len(w) - 1, 1))
            heads.append(b"</def></p>\n\n<p><hw>%s*%s</hw> <pr>(%s)</pr>, <pos>%s</pos> "
                         b"<ety>[%s]</ety> <def>" % (
                             w[:cut].capitalize(), w[cut:], w, pos[r.randrange(len(pos))],
                             (b"L.", b"F.", b"AS.", b"Gr.", b"OE.")[r.randrange(5)]))
        seps = [" ", ", ", "; ", ". ", " <i>", "</i> ", "</def>\n<sn>2.</sn> <def>",
                "</def> <au>Shak.</au>\n<def>", " <as>as, ", "</as> ", ""]
        weights = [700, 60, 30, 50, 10, 10, 12, 4, 5, 5, 25]
        return tokens(key, n, self.words, seps, weights,
                      head=b"<p>Webster's Revised Unabridged Dictionary</p>\n<def>",
                      heads=heads)


def _fixed(v: int) -> bytes:
    """`v` in 1/10000 as a 10-column fixed-point field."""
    a = abs(v)
    return (b"%s%d.%04d" % (b"-" if v < 0 else b"", a // 10000, a % 10000)).rjust(10)


def _le(x: int, k: int) -> bytes:
    return (x & ((1 << 8 * k) - 1)).to_bytes(k, "little")


def _operand(kind: str, v: int) -> bytes:
    """An x86 operand of `kind` from the 32 random bits `v`."""
    le = _le
    if kind == "i8":
        return le(4 * (v % 32), 1)
    if kind == "i16":
        return le(4 * (v % 16), 2)
    if kind in ("d8", "d8i32"):
        d = 8 + 4 * (v % 14) if v & 0x100 else 256 - 4 * (1 + (v >> 9) % 16)
        return le(d, 1) + (le((v >> 16) % 16, 4) if kind == "d8i32" else b"")
    if kind == "o8":
        return le(4 * (v % 40), 1)
    if kind == "r8":
        return le(v % 128 - 40, 1)
    if kind == "rel32":
        return le(v % (1 << 21) - (1 << 20), 4)
    if kind == "abs32":
        return le(0x5F800000 + 4 * (v % 512), 4)
    if kind == "i32":
        return le(v % 65536, 4)
    return b""


def make(seed: int, params: dict) -> Source:
    return Source(seed, params)
