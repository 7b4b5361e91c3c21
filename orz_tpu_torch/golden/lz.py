"""LZ codec core: ROLZ parse, word model, symrank + Huffman staging, chunk
(de)serialization (reference src/lz.rs); copied for the port from
``orz_tpu/golden/lz.py``.

Chunk wire layout (encode order, all through the MSB-first bit encoder):
  [first chunk of the stream only]
      varint  num_counted_symbols
      9 bits x num_counted_symbols   (symbols with count > 1, by desc count)
  varint  end_spos  (window position after this chunk)
  varint  n_items
  huffman table 1a (389 syms, after_literal=0)
  huffman table 1b (389 syms, after_literal=1)
  huffman table 2  (240 syms, long match-length extension)
  per item: huff1[after_literal] code
            [match] robits raw bits; [if lenid==5] huff2 code
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from orz_tpu_torch.bitio import BitDecoder, BitEncoder
from orz_tpu_torch.cfg import LZCfg
from orz_tpu_torch.constants import (
    LZ_CHUNK_SIZE,
    LZ_LENID_SIZE,
    LZ_MATCH_MAX_LEN,
    LZ_MATCH_MIN_LEN,
    LZ_ROID_DECODING_ARRAY,
    LZ_ROID_ENCODING_ARRAY,
    SYMRANK_NUM_SYMBOLS,
    WORD_SYMBOL,
    WORD_TABLE_SIZE,
)
from orz_tpu_torch.golden.huffman import HuffmanDecoding, build_code_lens, canonical_encodings
from orz_tpu_torch.golden.matcher import MatcherState
from orz_tpu_torch.golden.symrank import SymRankState

_ALNUM = np.zeros(256, dtype=np.int64)
for _b in range(256):
    _ALNUM[_b] = int(chr(_b).isascii() and chr(_b).isalnum())


def hash1(sbuf: np.ndarray, pos: int) -> int:
    """Literal/bucket context: low 7 bits of buf[pos] plus an
    is-alphanumeric bit of buf[pos-1] (reference src/lz.rs:481-486)."""
    return (int(sbuf[pos]) & 0x7F) | (int(_ALNUM[sbuf[pos - 1]]) << 7)


def hash2(sbuf: np.ndarray, pos: int) -> int:
    """Word-model context: 15 bits over buf[pos-2..pos+1]
    (reference src/lz.rs:488-492)."""
    return (int(sbuf[pos]) & 0x7F) | (hash1(sbuf, pos - 1) << 7)


@dataclass
class _Item:
    symbol: int
    sr_ctx: int
    sr_unlikely: int
    after_literal: bool
    is_match: bool = False
    robitlen: int = 0
    robits: int = 0
    encoded_match_len: int = 0


class _LZContext:
    """Model state shared by encoder and decoder (reference src/lz.rs:49-67)."""

    def __init__(self, with_chains: bool):
        self.matcher = MatcherState(with_chains=with_chains)
        self.symrank = SymRankState()
        self.words = np.zeros(WORD_TABLE_SIZE, dtype=np.int64)  # u16 little-endian pair
        self.first_block = True
        self.after_literal = True


class GoldenLZEncoder:
    def __init__(self):
        self.ctx = _LZContext(with_chains=True)

    def forward(self, forward_len: int) -> None:
        self.ctx.matcher.forward(forward_len)

    def encode_chunk(
        self, cfg: LZCfg, sbuf: np.ndarray, sbuf_len: int, spos: int, item_sink=None
    ) -> Tuple[int, bytes]:
        """Encode one chunk starting at spos; returns (new_spos, payload).

        sbuf must be physically padded with >= 480 zero bytes beyond sbuf_len
        (the sentinel region, reference src/lib.rs:54,67-69).
        Parse loop: reference src/lz.rs:131-235.
        """
        ctx = self.ctx
        mt = ctx.matcher
        enc = BitEncoder()
        items: List[_Item] = []

        while spos < sbuf_len and len(items) < LZ_CHUNK_SIZE:
            c1 = hash1(sbuf, spos - 1)
            last_word = int(ctx.words[hash2(sbuf, spos - 1)])
            cur_word = int(sbuf[spos]) | int(sbuf[spos + 1]) << 8
            last_word_matched = cur_word == last_word
            sr_ctx = c1 | (int(ctx.after_literal) << 8)
            sr_unlikely = last_word & 0xFF

            lazy_match_id = 0
            m = mt.find_match(c1, sbuf, sbuf_len, spos, cfg.match_depth)
            if m.match_len > 0:
                roid, robitlen, robits = LZ_ROID_ENCODING_ARRAY[m.reduced_offset]

                if m.match_len < LZ_MATCH_MAX_LEN // 2:
                    lazy_len1 = m.match_len + 1 + (1 if robitlen < 8 else 0)
                    lazy_len2 = lazy_len1 - (1 if last_word_matched else 0)
                    if mt.has_lazy_match(hash1(sbuf, spos), sbuf, spos + 1, lazy_len1, cfg.lazy_match_depth1):
                        lazy_match_id = 1
                    elif mt.has_lazy_match(hash1(sbuf, spos + 1), sbuf, spos + 2, lazy_len2, cfg.lazy_match_depth2):
                        lazy_match_id = 2

                if lazy_match_id == 0:
                    if m.match_len > m.match_len_expected:
                        encoded_match_len = m.match_len - m.match_len_min
                    elif m.match_len < m.match_len_expected:
                        encoded_match_len = m.match_len - m.match_len_min + 1
                    else:
                        encoded_match_len = 0
                    assert encoded_match_len >= 0, (
                        "reference invariant: coded length never below the "
                        "node's len_min (see docs/OTZ2_DESIGN.md)"
                    )
                    lenid = min(LZ_LENID_SIZE - 1, encoded_match_len)
                    items.append(
                        _Item(
                            symbol=256 + roid * LZ_LENID_SIZE + lenid,
                            sr_ctx=sr_ctx,
                            sr_unlikely=sr_unlikely,
                            after_literal=ctx.after_literal,
                            is_match=True,
                            robitlen=robitlen,
                            robits=robits,
                            encoded_match_len=encoded_match_len,
                        )
                    )
                    mt.bucket_update(c1, spos, m.reduced_offset, m.match_len)
                    mt.matcher_update(c1, sbuf, spos)
                    spos += m.match_len
                    ctx.after_literal = False
                    ctx.words[hash2(sbuf, spos - 3)] = int(sbuf[spos - 2]) | int(sbuf[spos - 1]) << 8
                    continue

            mt.bucket_update(c1, spos, 0, 0)
            mt.matcher_update(c1, sbuf, spos)

            if spos + 1 < sbuf_len and lazy_match_id != 1 and last_word_matched:
                items.append(_Item(WORD_SYMBOL, sr_ctx, sr_unlikely, ctx.after_literal))
                spos += 2
                ctx.after_literal = False
            else:
                items.append(_Item(int(sbuf[spos]), sr_ctx, sr_unlikely, ctx.after_literal))
                spos += 1
                ctx.after_literal = True
                ctx.words[hash2(sbuf, spos - 3)] = int(sbuf[spos - 2]) | int(sbuf[spos - 1]) << 8

        if item_sink is not None:  # diagnostics hook (tools/ratio_diag.py)
            item_sink.extend(items)

        # first chunk of the stream: symbol census -> shared symrank init
        # (reference src/lz.rs:238-265)
        if ctx.first_block:
            counts = [0] * SYMRANK_NUM_SYMBOLS
            for it in items:
                counts[it.symbol] += 1
            num_counted = sum(1 for cnt in counts if cnt > 1)
            vs = sorted(range(SYMRANK_NUM_SYMBOLS), key=lambda s: -max(counts[s], 1))
            enc.encode_varint(num_counted)
            for s in vs[:num_counted]:
                enc.encode_raw_bits(s, 9)
            ctx.symrank.init_all(vs)
            ctx.first_block = False

        enc.encode_varint(min(spos, sbuf_len))
        enc.encode_varint(len(items))

        # symrank transform pass + Huffman weight census (reference src/lz.rs:272-305)
        w1 = [[0] * SYMRANK_NUM_SYMBOLS, [0] * SYMRANK_NUM_SYMBOLS]
        w2 = [0] * LZ_MATCH_MAX_LEN
        for it in items:
            es = ctx.symrank.encode(it.sr_ctx, it.symbol, it.sr_unlikely)
            w1[int(it.after_literal)][es] += 1
            if it.is_match and it.encoded_match_len >= LZ_LENID_SIZE - 1:
                w2[it.encoded_match_len] += 1
            it.symbol = es

        lens = [
            build_code_lens(w1[0], 15)[0],
            build_code_lens(w1[1], 15)[0],
            build_code_lens(w2, 15)[0],
        ]
        for code_lens in lens:
            enc.encode_huffman_table(code_lens)
        e1 = [canonical_encodings(lens[0]), canonical_encodings(lens[1])]
        e2 = canonical_encodings(lens[2])

        # bit-pack pass (reference src/lz.rs:320-344)
        for it in items:
            enc.encode_huffman_sym(e1[int(it.after_literal)], it.symbol)
            if it.is_match:
                enc.encode_raw_bits(it.robits, it.robitlen)
                if it.encoded_match_len >= LZ_LENID_SIZE - 1:
                    enc.encode_huffman_sym(e2, it.encoded_match_len)

        return spos, enc.finish()


class FormatError(Exception):
    pass


class GoldenLZDecoder:
    def __init__(self):
        self.ctx = _LZContext(with_chains=False)

    def forward(self, forward_len: int) -> None:
        self.ctx.matcher.forward(forward_len)

    def decode_chunk(self, tbuf: bytes, sbuf: np.ndarray, sbuf_cap: int, spos: int) -> int:
        """Decode one chunk payload into sbuf starting at spos; returns the
        end position (reference src/lz.rs:366-478)."""
        ctx = self.ctx
        mt = ctx.matcher
        dec = BitDecoder(tbuf)

        if ctx.first_block:
            num_counted = dec.decode_varint()
            if num_counted > SYMRANK_NUM_SYMBOLS:
                raise FormatError("bad symbol census")
            vs = []
            seen = [False] * SYMRANK_NUM_SYMBOLS
            for _ in range(num_counted):
                s = dec.decode_raw_bits(9)
                if s >= SYMRANK_NUM_SYMBOLS:
                    raise FormatError("census symbol out of range")
                vs.append(s)
                seen[s] = True
            for s in range(SYMRANK_NUM_SYMBOLS):
                if not seen[s]:
                    vs.append(s)
            ctx.symrank.init_all(vs[:SYMRANK_NUM_SYMBOLS])
            ctx.first_block = False

        sbuf_len = dec.decode_varint()
        n_items = dec.decode_varint()
        if sbuf_len > sbuf_cap:
            raise FormatError("chunk output exceeds window")

        tables = []
        for _ in range(3):
            code_lens, max_code_len = dec.decode_huffman_table()
            tables.append(HuffmanDecoding(code_lens, max_code_len))
        huff1 = tables[:2]
        huff2 = tables[2]

        for _ in range(n_items):
            symbol = dec.decode_huffman_sym(huff1[int(ctx.after_literal)])
            if symbol >= SYMRANK_NUM_SYMBOLS:
                raise FormatError("symbol out of range")

            c1 = hash1(sbuf, spos - 1)
            last_word = int(ctx.words[hash2(sbuf, spos - 1)])
            sr_ctx = c1 | (int(ctx.after_literal) << 8)
            v = ctx.symrank.decode(sr_ctx, symbol, last_word & 0xFF)

            if v == WORD_SYMBOL:
                mt.bucket_update(c1, spos, 0, 0)
                ctx.after_literal = False
                if spos + 2 > sbuf_cap:
                    raise FormatError("write past window")
                sbuf[spos] = last_word & 0xFF
                sbuf[spos + 1] = last_word >> 8
                spos += 2
            elif v <= 255:
                mt.bucket_update(c1, spos, 0, 0)
                ctx.after_literal = True
                if spos + 1 > sbuf_cap:
                    raise FormatError("write past window")
                sbuf[spos] = v
                spos += 1
                ctx.words[hash2(sbuf, spos - 3)] = int(sbuf[spos - 2]) | int(sbuf[spos - 1]) << 8
            else:
                roid = (v - 256) // LZ_LENID_SIZE
                lenid = (v - 256) % LZ_LENID_SIZE
                robase, robitlen = LZ_ROID_DECODING_ARRAY[roid]
                reduced_offset = robase + dec.decode_raw_bits(robitlen)
                match_pos, len_min_raw, expected_raw = mt.get_node(c1, reduced_offset)

                if lenid == LZ_LENID_SIZE - 1:
                    encoded_match_len = dec.decode_huffman_sym(huff2)
                else:
                    encoded_match_len = lenid

                match_len_min = max(len_min_raw, LZ_MATCH_MIN_LEN)
                match_len_expected = max(expected_raw, LZ_MATCH_MIN_LEN)
                if encoded_match_len + match_len_min > match_len_expected:
                    match_len = encoded_match_len + match_len_min
                elif encoded_match_len > 0:
                    match_len = encoded_match_len + match_len_min - 1
                else:
                    match_len = match_len_expected

                mt.bucket_update(c1, spos, reduced_offset, match_len)
                ctx.after_literal = False
                if spos + match_len > sbuf_cap or match_pos + match_len > sbuf_cap or match_pos >= spos:
                    raise FormatError("bad match span")
                # byte-wise LZ copy: equivalent to the reference's dword-step
                # overlap-doubling copy within [spos, spos+match_len)
                # (reference src/mem.rs:74-92)
                for k in range(match_len):
                    sbuf[spos + k] = sbuf[match_pos + k]
                spos += match_len
                ctx.words[hash2(sbuf, spos - 3)] = int(sbuf[spos - 2]) | int(sbuf[spos - 1]) << 8

        return min(spos, sbuf_len)
