"""Format-defining constants of the ORZ stream format, copied for the port
from ``orz_tpu/constants.py``.

These are the host codecs' (golden, native, the orz and ORZP containers):
the OTZ device format has its own values under some of the same names
(``SYMRANK_NUM_SYMBOLS`` 431 there, 389 here; ``WORD_SYMBOL``; the ROID
tables) in ``spec.py``, so the two modules stay apart.

These values are the compatibility contract with the reference implementation
(richox/orz v1.6.1).  Every value here leaks into the bit-stream, so they must
be reproduced exactly.  Citations point at the reference:

- block/window/chunk sizes: reference src/lib.rs:31-34,54-55
- ROLZ ring/hash sizes:     reference src/lz.rs:24, src/matcher.rs:18
- symbol space:             reference src/lz.rs:25-29
- ROID extra-bit schedule:  reference src/lz.rs:494-534
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Container / window geometry (reference src/lib.rs:31-34,54-55)
# ---------------------------------------------------------------------------

LZ_BLOCK_SIZE = (1 << 25) - 1  # 33,554,431: sliding-window block size
LZ_CHUNK_SIZE = 1 << 20  # max match-items per chunk
LZ_MATCH_MAX_LEN = 240  # must be a multiple of 16
LZ_MATCH_MIN_LEN = 4

SBVEC_SENTINEL_LEN = LZ_MATCH_MAX_LEN * 2  # 480 bytes of zero padding each side
SBVEC_PREMATCH_LEN = LZ_BLOCK_SIZE // 2  # 16,777,215 carried-window bytes

# Fresh bytes consumed per block = LZ_BLOCK_SIZE - SBVEC_PREMATCH_LEN
LZ_BLOCK_FRESH_LEN = LZ_BLOCK_SIZE - SBVEC_PREMATCH_LEN  # 16,777,216

# Decoder-side chunk length sanity bound (reference src/lib.rs:103,111-113)
LZ_TBUF_CAPACITY = SBVEC_PREMATCH_LEN * 3

# ---------------------------------------------------------------------------
# ROLZ match-finder geometry (reference src/lz.rs:24, src/matcher.rs:18)
# ---------------------------------------------------------------------------

LZ_MF_BUCKET_ITEM_SIZE = 4094  # per-context ring of recent item-start positions
LZ_MF_BUCKET_ITEM_HASH_SIZE = int(LZ_MF_BUCKET_ITEM_SIZE * 1.13) | 1  # 4627
LZ_NUM_BUCKETS = 256  # one per hash1 context

assert LZ_MF_BUCKET_ITEM_HASH_SIZE == 4627

# ---------------------------------------------------------------------------
# Symbol space (reference src/lz.rs:25-29)
# ---------------------------------------------------------------------------

LZ_ROID_SIZE = 22  # number of reduced-offset ids
LZ_LENID_SIZE = 6  # number of length ids
SYMRANK_NUM_SYMBOLS = 256 + LZ_ROID_SIZE * LZ_LENID_SIZE + 1  # 389
WORD_SYMBOL = SYMRANK_NUM_SYMBOLS - 1  # 388
SYMRANK_NUM_CONTEXTS = 512  # 256 hash1 contexts x 2 after_literal states

WORD_TABLE_SIZE = 1 << 15  # 32768 two-byte-word contexts (hash2)

HUFFMAN_MAX_CODE_LEN = 15  # reference src/lz.rs:307-310

# dword hash mix constants (reference src/matcher.rs:258-259)
HASH_DWORD_MULS = (131313131, 1313131, 13131, 131)
HASH_DWORD_ADDS = (797, 79797, 7979797, 797979797)

# ---------------------------------------------------------------------------
# ROID (reduced-offset id) tables (reference src/lz.rs:494-534)
#
# Reduced offsets 0..4093 are grouped into 22 ids; id i carries i//2 extra raw
# bits, so ids cover runs of 1,1,2,2,4,4,...,1024,1024 offsets = 4094 exactly.
# ---------------------------------------------------------------------------


def _build_roid_tables(ring_size: int = LZ_MF_BUCKET_ITEM_SIZE, group: int = 2):
    enc = []  # reduced_offset -> (roid, robitlen, robits)
    dec = []  # roid -> (robase, robitlen)
    base = 0
    current_id = 0
    while base < ring_size:
        bit_len = current_id // group
        dec.append((base, bit_len))
        rest = 0
        while rest != (1 << bit_len):
            if base < ring_size:
                enc.append((current_id, bit_len, rest))
                base += 1
            rest += 1
        current_id += 1
    return tuple(enc), tuple(dec)


build_roid_tables = _build_roid_tables  # parameterized form for OTZ


LZ_ROID_ENCODING_ARRAY, LZ_ROID_DECODING_ARRAY = _build_roid_tables()

assert len(LZ_ROID_ENCODING_ARRAY) == LZ_MF_BUCKET_ITEM_SIZE
assert len(LZ_ROID_DECODING_ARRAY) == LZ_ROID_SIZE
assert LZ_ROID_ENCODING_ARRAY[-1][0] == LZ_ROID_SIZE - 1
