"""Plain reference decoder of the ORZT container and its OTZ segments.

Written from the format's description (the segment bit stream and model
semantics in the docstring of the port's sequential oracle, and the ORZT
framing) in plain Python, with no numpy, no torch and nothing of the
program.  It is the benchmark's judge of what the encoder produced: an
encoded input is correct when every segment decodes to the input's bytes.

ORZT container:
    b"ORZT\\x01", byte varint segment_size,
    repeat: byte varint len(payload) + payload, then byte varint 0.
Byte varints are base 128, low digits first, 128 marking continuation.

OTZ segment (MSB-first bits, read 32 at a time; in-stream varints are
2-bit groups, the low bit a value bit and the high bit "more"):
    varint raw_len, varint chunk_input, [raw_len 0 ends]
    1 bit pred_len, 1 bit rings_mode, 1 bit words_mode
    varint num_counted, num_counted x 9-bit symbols (symbol-rank order)
    per chunk: varint n_items, Huffman tables A (431), B (431), C (256),
        then per item: a code of A (after a literal) or B; for a match,
        robitlen raw bits; for length id 5, a code of C.
"""

from __future__ import annotations

from array import array

M64 = (1 << 64) - 1
MAGIC = b"ORZT\x01"

PAD_FRONT = 16
MATCH_MIN = 4
MATCH_MAX = 240
PAD_TAIL = MATCH_MAX + 32
LENIDS = 6
RING = 32766
FENCE = 4096
N_CTX = 256
WORD_TABLE = 1 << 15
MAX_CODE_LEN = 15


def roid_table(ring: int = RING, group: int = 2) -> list[tuple[int, int]]:
    """Reduced-offset id -> (base, raw bit count): ids cover runs of
    1, 1, 2, 2, 4, 4, ... offsets up to `ring`."""
    out, base, rid = [], 0, 0
    while base < ring:
        bits = rid // group
        out.append((base, bits))
        base += 1 << bits
        rid += 1
    return out


ROID = roid_table()
REP0_BASE = 256 + len(ROID) * LENIDS  # 424
N_SYM = REP0_BASE + LENIDS + 1  # 431
WORD_SYM = N_SYM - 1
TOP = N_SYM - 1
TABC = MATCH_MAX + 16
NEG_EML_BASE = MATCH_MAX
ALNUM = bytes(int(chr(b).isascii() and chr(b).isalnum()) for b in range(256))


class FormatError(ValueError):
    pass


def read_container(stream: bytes) -> tuple[int, list[bytes]]:
    """(segment_size, payloads) of an ORZT stream; raises FormatError on a
    bad magic, a truncated payload or bytes after the end mark."""
    if stream[:5] != MAGIC:
        raise FormatError("bad magic")
    pos = 5

    def varint():
        nonlocal pos
        v, f = 0, 1
        while True:
            if pos >= len(stream):
                raise FormatError("truncated length")
            b = stream[pos]
            pos += 1
            if b < 128:
                return v + b * f
            v += (b - 128) * f
            f *= 128

    seg = varint()
    payloads = []
    while True:
        n = varint()
        if n == 0:
            break
        if pos + n > len(stream):
            raise FormatError("truncated segment")
        payloads.append(stream[pos:pos + n])
        pos += n
    if pos != len(stream):
        raise FormatError("bytes after the end mark")
    return seg, payloads


def _lut(lens: list[int], max_len: int) -> list[int]:
    """Canonical Huffman decoding table over max_len peeked bits: each
    entry symbol << 4 | code length."""
    if max_len > MAX_CODE_LEN:
        raise FormatError("code length over the limit")
    lut = [0] * (1 << max_len)
    code, cur = 0, 1
    for ln, s in sorted((ln, s) for s, ln in enumerate(lens) if ln > 0):
        if ln > max_len:
            raise FormatError("code longer than the table")
        code <<= ln - cur
        cur = ln
        rest = max_len - ln
        base = code << rest
        if base + (1 << rest) > len(lut):
            raise FormatError("oversubscribed code")
        lut[base:base + (1 << rest)] = [s << 4 | ln] * (1 << rest)
        code += 1
    return lut


def segment_header(payload: bytes) -> tuple[int, int]:
    """(raw_len, chunk_input) of an OTZ segment."""
    val = int.from_bytes(bytes(payload[:32]) + bytes(32 - min(len(payload), 32)), "big")
    nb = 256
    out = []
    for _ in range(2):
        v, shift = 0, 0
        while True:
            if nb < 2:
                raise FormatError("header past its bytes")
            nb -= 2
            b = (val >> nb) & 3
            v |= (b & 1) << shift
            shift += 1
            if b <= 1:
                break
        out.append(v)
    return out[0], out[1]


def decode_segment(payload: bytes, limit: int | None = None) -> bytes:
    """One OTZ segment -> its bytes.  With `limit`, stop once at least
    `limit` bytes are decoded and return what was decoded."""
    inp = bytes(payload) + bytes(8)
    pos = 0
    val = 0
    nb = 0

    # bit reader, as closures for the header; the item loop inlines them
    def bits(k):
        nonlocal pos, val, nb
        if nb < 32:
            val = ((val << 32) | int.from_bytes(inp[pos:pos + 4], "big")) & M64
            nb += 32
            pos += 4
        nb -= k
        return (val >> nb) & ((1 << k) - 1)

    def varint():
        v, shift = 0, 0
        while True:
            b = bits(2)
            v |= (b & 1) << shift
            shift += 1
            if b <= 1:
                return v
            if shift > 62:
                raise FormatError("varint overflow")

    def table(nsym):
        max_len = varint()
        lens = []
        while True:
            d = varint()
            if d == 0:
                break
            if len(lens) + d > nsym:
                raise FormatError("oversized table")
            lens.extend([0] * (d - 1))
            lens.append(max_len - varint())
        if len(lens) > nsym:
            raise FormatError("oversized table")
        return _lut(lens, max_len), max_len

    raw_len = varint()
    chunk_input = varint()
    if raw_len == 0:
        return b""
    if raw_len > 1 << 31 or not 0 < chunk_input <= 1 << 31:
        raise FormatError("implausible header")
    pred_len = bits(1)
    rings_mode = bits(1)
    words_mode = bits(1)
    num_counted = varint()
    if num_counted > N_SYM:
        raise FormatError("bad census")
    order = [bits(9) for _ in range(num_counted)]
    if len(set(order)) != len(order) or any(s >= N_SYM for s in order):
        raise FormatError("bad census symbol")
    seen = set(order)
    order += [s for s in range(N_SYM) if s not in seen]

    # symbol ranking: per context a permutation, its inverse, a count and
    # a decayed sum of ranks (2 x 256 contexts)
    va = [list(order) for _ in range(512)]
    inv = [0] * N_SYM
    for i, s in enumerate(order):
        inv[s] = i
    ia = [list(inv) for _ in range(512)]
    cnt = [0] * 512
    isum = [1000000] * 512

    end = PAD_FRONT + raw_len
    stop = end if limit is None else min(end, PAD_FRONT + limit)
    buf = bytearray(end + PAD_TAIL)
    words = [0] * WORD_TABLE
    rings = [array("q") for _ in range(N_CTX)]
    ring_add = [r.append for r in rings]
    expected = array("i", bytes(4 * len(buf)))
    len_min = bytearray(len(buf))
    alnum = ALNUM
    p = PAD_FRONT
    done_ring = PAD_FRONT  # next position to enter its ring (rings_mode 0)
    done_word = PAD_FRONT  # next word update to apply (words_mode 0)
    after_literal = 1
    last_dist = 0
    n_chunks = max(1, -(-raw_len // chunk_input))
    for _ in range(n_chunks):
        if p >= stop:
            break
        n_items = varint()
        (lut_a, ml_a), (lut_b, ml_b), (lut_c, ml_c) = (
            table(N_SYM), table(N_SYM), table(TABC))
        for _ in range(n_items):
            if p >= stop:
                break
            if not rings_mode:  # every position q < p is in its ring
                for q in range(done_ring, p):
                    ring_add[(buf[q - 1] & 0x7F) | alnum[buf[q - 2]] << 7](q)
                done_ring = p
            if not words_mode:  # word updates at u <= p - 3 are visible
                for u in range(done_word, p - 2):
                    words[(buf[u] & 0x7F) | ((buf[u - 1] & 0x7F) | alnum[buf[u - 2]] << 7) << 7] = \
                        buf[u + 1] | buf[u + 2] << 8
                done_word = max(done_word, p - 2)
            p0 = p
            c1 = (buf[p - 1] & 0x7F) | alnum[buf[p - 2]] << 7
            last_word = words[(buf[p - 1] & 0x7F) | ((buf[p - 2] & 0x7F) | alnum[buf[p - 3]] << 7) << 7]
            ctx = c1 | after_literal << 8
            # Huffman symbol
            if nb < 32:
                val = ((val << 32) | int.from_bytes(inp[pos:pos + 4], "big")) & M64
                nb += 32
                pos += 4
            if after_literal:
                e = lut_a[(val >> (nb - ml_a)) & ((1 << ml_a) - 1)] if ml_a else 0
            else:
                e = lut_b[(val >> (nb - ml_b)) & ((1 << ml_b) - 1)] if ml_b else 0
            nb -= e & 15
            i = e >> 4
            # symbol-rank decode and update
            iac = ia[ctx]
            vac = va[ctx]
            iu = iac[last_word & 0xFF]
            if i == TOP:
                i = iu
            elif i >= iu:
                i += 1
            if i >= N_SYM:
                raise FormatError("rank out of range")
            v = vac[i]
            c = cnt[ctx]
            if c > N_SYM:
                c = c * 9 // 10
                isum[ctx] = isum[ctx] * 9 // 10
            c += 1
            cnt[ctx] = c
            s = isum[ctx] + i
            isum[ctx] = s
            step = i // 16 + ((s // 16 // c) & 0xFFFF)
            nxt = max(i - step, 0, i // 2)
            d = i - nxt
            if d == 1:
                w1 = vac[nxt]
                iac[v] = nxt
                vac[i] = w1
                iac[w1] = i
                vac[nxt] = v
            elif d > 1:
                n1 = nxt + d // 2
                w1 = vac[n1]
                w2 = vac[nxt]
                vac[i] = w1
                iac[w1] = i
                vac[n1] = w2
                iac[w2] = n1
                vac[nxt] = v
                iac[v] = nxt

            if v == WORD_SYM:
                if p + 2 > end:
                    raise FormatError("word past the end")
                buf[p] = last_word & 0xFF
                buf[p + 1] = last_word >> 8
                p += 2
                after_literal = 0
            elif v < 256:
                buf[p] = v
                p += 1
                after_literal = 1
            else:
                if v >= REP0_BASE:
                    lenid = v - REP0_BASE
                    if last_dist <= 0:
                        raise FormatError("rep0 with no match before")
                    q = p - last_dist
                else:
                    roid, lenid = divmod(v - 256, LENIDS)
                    base, k = ROID[roid]
                    if k:
                        if nb < 32:
                            val = ((val << 32) | int.from_bytes(inp[pos:pos + 4], "big")) & M64
                            nb += 32
                            pos += 4
                        nb -= k
                        ro = base + ((val >> nb) & ((1 << k) - 1))
                    else:
                        ro = base
                    ring = rings[c1]
                    if ro >= len(ring):
                        raise FormatError("reduced offset out of range")
                    q = ring[len(ring) - 1 - ro]
                if lenid == LENIDS - 1:
                    if nb < 32:
                        val = ((val << 32) | int.from_bytes(inp[pos:pos + 4], "big")) & M64
                        nb += 32
                        pos += 4
                    e = lut_c[(val >> (nb - ml_c)) & ((1 << ml_c) - 1)] if ml_c else 0
                    nb -= e & 15
                    eml = e >> 4
                else:
                    eml = lenid
                if q >= p or q < PAD_FRONT:
                    raise FormatError("bad match target")
                if pred_len:
                    room = min(FENCE - ((p - PAD_FRONT) % FENCE), end - p)
                    lm = min(max(len_min[q], MATCH_MIN), room)
                    ex = max(expected[q], MATCH_MIN)
                    if eml >= NEG_EML_BASE:
                        n = lm - 1 - (eml - NEG_EML_BASE)
                    elif eml + lm > ex:
                        n = eml + lm
                    elif eml > 0:
                        n = eml + lm - 1
                    else:
                        n = ex
                    if len_min[q] <= n:
                        len_min[q] = min(n + 1, 127)
                    expected[p] = n
                else:
                    n = eml + MATCH_MIN
                if n < MATCH_MIN or p + n > end:
                    raise FormatError("bad match span")
                dist = p - q
                if dist >= n:
                    buf[p:p + n] = buf[q:q + n]
                else:  # overlapping copy repeats the last `dist` bytes
                    buf[p:p + n] = (buf[q:p] * (n // dist + 1))[:n]
                last_dist = dist
                p += n
                after_literal = 0

            if rings_mode:
                rings[c1].append(p0)
            if words_mode and p - p0 != 2:
                words[(buf[p - 3] & 0x7F) | ((buf[p - 4] & 0x7F) | alnum[buf[p - 5]] << 7) << 7] = \
                    buf[p - 2] | buf[p - 1] << 8
    if limit is None and p != end:
        raise FormatError("decoded length differs from the header")
    return bytes(buf[PAD_FRONT:min(p, end)])
