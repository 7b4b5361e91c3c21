"""The bit writer the port's stream assembly uses, copied.

``BitEncoder`` with the methods that ``device/host.assemble_segment_np``
and the segment framing call, copied from ``orz_tpu/golden/bitio.py``
(reference src/coder.rs): MSB-first bits over big-endian u32 words through
a 64-bit staging buffer; the in-bitstream varint emits 2-bit groups (value
bit, continuation bit).  ``tests/test_torch_host.py`` holds its output to
the original's.
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1


class BitEncoder:
    """MSB-first bit writer over big-endian u32 words."""

    __slots__ = ("out", "_val", "_len")

    def __init__(self):
        self.out = bytearray()
        self._val = 0
        self._len = 0

    def _reserve32(self) -> None:
        if self._len >= 32:
            self._len -= 32
            self.out += ((self._val >> self._len) & 0xFFFFFFFF).to_bytes(4, "big")
            self._val &= (1 << self._len) - 1

    def _put(self, nbits: int, bits: int) -> None:
        nbits = int(nbits)
        bits = int(bits)
        self._val = ((self._val << nbits) | (bits & ((1 << nbits) - 1))) & _MASK64
        self._len += nbits

    def encode_raw_bits(self, bits: int, nbits: int) -> None:
        self._reserve32()
        self._put(nbits, bits)

    def encode_varint(self, v: int) -> None:
        while True:
            self._reserve32()
            has_next = v > 0b01
            self._put(2, (v & 0b01) | (int(has_next) << 1))
            v >>= 1
            if not has_next:
                break

    def encode_huffman_table(self, code_lens) -> None:
        """max_len, then per nonzero symbol varint sym_delta and varint
        max_len - len, 0-terminated (reference src/coder.rs:45-67)."""
        if len(code_lens) == 0:
            raise ValueError("encode_huffman_table: empty table")
        max_code_len = max(code_lens)
        self.encode_varint(max_code_len)
        last_sym = -1
        for sym, code_len in enumerate(code_lens):
            if code_len > 0:
                sym_delta = sym + 1 if last_sym < 0 else sym - last_sym
                self.encode_varint(sym_delta)
                self.encode_varint(max_code_len - code_len)
                last_sym = sym
        self.encode_varint(0)

    def append_bits_bulk(self, words, nbits: int) -> None:
        """Splice a device-packed bit region (big-endian u32 words, bit 0 =
        MSB of words[0]) in at the current bit position."""
        nbits = int(nbits)
        if nbits <= 0:
            return
        words = np.ascontiguousarray(words[: (nbits + 31) // 32], dtype=np.uint32)
        full = nbits // 32
        rem = nbits % 32
        self._reserve32()
        r = self._len  # residue bits currently staged (< 32)
        if full:
            if r == 0:
                self.out += words[:full].astype(">u4").tobytes()
            else:
                w = words[:full].astype(np.uint64)
                heads = np.empty(full, dtype=np.uint64)
                heads[0] = self._val & ((1 << r) - 1)
                heads[1:] = w[:-1] & ((1 << r) - 1)
                merged = ((heads << np.uint64(32 - r)) | (w >> np.uint64(r))).astype(
                    np.uint32
                )
                self.out += merged.astype(">u4").tobytes()
                self._val = int(words[full - 1]) & ((1 << r) - 1)
        if rem:
            last = (int(words[full]) >> (32 - rem)) & ((1 << rem) - 1)
            self._reserve32()
            self._put(rem, last)

    def finish(self) -> bytes:
        """Pad the residue to a full 32-bit word and return the bytes
        (reference src/coder.rs:75-82,209-216)."""
        self._reserve32()
        if self._len > 0:
            self._put(32 - self._len, 0)
            while self._len > 0:
                self.out.append((self._val >> (self._len - 8)) & 0xFF)
                self._len -= min(8, self._len)
            self._val = 0
        return bytes(self.out)
