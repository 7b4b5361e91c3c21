"""OTZ format constants and knobs the port needs, copied.

Copied from ``orz_tpu/device/spec.py``, so that the port imports nothing
of the JAX package; the few ORZ constants the OTZ format shares (match
lengths, length ids, the Huffman code cap, the ROID table function) come
from the port's copy of ``orz_tpu/constants.py``, ``constants.py``, whose
other values (the symbol count, ``WORD_SYMBOL``, the ROID tables) differ
from OTZ's here.  ``tests/test_torch_host.py`` pins every copy to its
original.  The numpy model functions at the end (``cctx_all``, ``h2_all``,
``dword_all``, ``match_key_all``) and the numpy ``min_match_len_for_ro``
serve the sequential oracle ``device/refcodec.py``
(``tests/test_torch_refcodec.py`` pins them); the torch price gate lives
beside the kernels (``kernels/match_depth.py``).  The environment
variables are the JAX package's own knobs, read at the same moment as
there: ``OTZ2_SHIFTS``, ``OTZ2_NEAR``, ``OTZ2_ITERS``,
``OTZ2_CONFORM_CAP``, ``OTZ2_CONFORM_SHIFTS`` and ``OTZ_FAR_GATE`` at
import, ``OTZ2_SCHEDULE`` (with ``OTZ2_ITERS`` / ``OTZ2_SHIFTS``) and
``OTZ2`` at each call of ``otz2_schedule`` / ``otz2_enabled``.
"""

from __future__ import annotations

import os

import numpy as np

from orz_tpu_torch.constants import (  # the ORZ format's, shared by OTZ
    HUFFMAN_MAX_CODE_LEN,
    LZ_LENID_SIZE,
    LZ_MATCH_MAX_LEN,
    LZ_MATCH_MIN_LEN,
    WORD_TABLE_SIZE,
    build_roid_tables,
)

# --- orz_tpu/device/spec.py --------------------------------------------------

OTZ_MAGIC = b"OTZ1"
PAD_FRONT = 16
PAD_TAIL = LZ_MATCH_MAX_LEN + 32
RING = 32766  # reachable reduced offsets (OTZ1 rings, conform cap)
OTZ_ROID_GROUP = 2
_enc, _dec = build_roid_tables(RING, OTZ_ROID_GROUP)
ROID_ENC = np.asarray(_enc, dtype=np.int32)
ROID_DEC = np.asarray(_dec, dtype=np.int32)
OTZ_ROID_SIZE = len(ROID_DEC)  # 28
REP0_BASE = 256 + OTZ_ROID_SIZE * LZ_LENID_SIZE
SYMRANK_NUM_SYMBOLS = REP0_BASE + LZ_LENID_SIZE + 1  # 431
WORD_SYMBOL = SYMRANK_NUM_SYMBOLS - 1
TABC_SIZE = LZ_MATCH_MAX_LEN + 16
NEG_EML_BASE = LZ_MATCH_MAX_LEN
NEG_EML_DEPTH = 16
CHUNK_INPUT_DEFAULT = 1 << 21
ROID_GROUP_BITS = 1
FENCE = 4096
NUM_CONTEXTS = 256  # hash1-style byte contexts

# OTZ2 (item-start rings, rings_mode=1)
OTZ2_SHIFTS = int(os.environ.get("OTZ2_SHIFTS", "96"))
OTZ2_NEAR = int(os.environ.get("OTZ2_NEAR", "96"))
OTZ2_ITERS = int(os.environ.get("OTZ2_ITERS", "6"))
OTZ2_REPAIR_PASSES = 6
OTZ2_RO_CAP = 4094  # iteration analyses' reduced-offset cap
OTZ2_CONFORM_CAP = int(os.environ.get("OTZ2_CONFORM_CAP", str(RING)))
OTZ2_CONFORM_SHIFTS = int(os.environ.get("OTZ2_CONFORM_SHIFTS", "0"))


def otz2_schedule(level: int = 2) -> list:
    """Per-iteration shift depths: 96x1 + 384x11 at l2, 96x1 + 384x19 at
    l3; ``OTZ2_SCHEDULE="96x4,384x6"``-style strings, or OTZ2_ITERS /
    OTZ2_SHIFTS for uniform schedules, override it."""
    s = os.environ.get("OTZ2_SCHEDULE", "")
    if not s:
        if os.environ.get("OTZ2_ITERS") or os.environ.get("OTZ2_SHIFTS"):
            return [OTZ2_SHIFTS] * OTZ2_ITERS
        if level >= 3:
            return [96] * 1 + [384] * 19
        return [96] * 1 + [384] * 11
    out = []
    for part in s.split(","):
        v, _, r = part.partition("x")
        out += [int(v)] * (int(r) if r else 1)
    return out


def otz2_enabled(level: int) -> bool:
    """Item-start rings are the default from level 2; OTZ2=0 turns them
    off."""
    return os.environ.get("OTZ2", "1") == "1" and level >= 2


FAR_RO_1 = 4094
FAR_RO_2 = 16382
_FAR_GATE = int(os.environ.get("OTZ_FAR_GATE", "2"))


def min_match_len_for_ro(ro):
    """Minimum acceptable match length given the reduced offset (numpy
    scalars and arrays)."""
    return (LZ_MATCH_MIN_LEN + _FAR_GATE * (ro >= FAR_RO_1)
            + _FAR_GATE * (ro >= FAR_RO_2))


LEVEL_CANDIDATES = {0: 4, 1: 8, 2: 32, 3: 32}
LAZY_LEN_CAP = LZ_MATCH_MAX_LEN // 2
ROBITS_CHEAP = 8


def candidate_depth(level: int) -> int:
    return LEVEL_CANDIDATES[level]


def n_chunks_for(raw_len: int, chunk_input: int) -> int:
    return max(1, -(-raw_len // chunk_input))


_ALNUM = np.zeros(256, dtype=np.int32)
for _b in range(256):
    _ALNUM[_b] = int(chr(_b).isascii() and chr(_b).isalnum())


# --- pure per-position model functions (numpy, vectorized over positions) ---


def cctx_all(buf: np.ndarray) -> np.ndarray:
    """Byte context in which each position is coded: low 7 bits of the
    previous byte plus an is-alphanumeric bit of the byte before that."""
    b = buf.astype(np.int32)
    prev1 = np.roll(b, 1)
    prev2 = np.roll(b, 2)
    prev1[0] = 0
    prev2[:2] = 0
    return (prev1 & 0x7F) | (_ALNUM[prev2] << 7)


def h2_all(buf: np.ndarray) -> np.ndarray:
    """Word-model key AT each position x, over bytes x-2..x: 15 bits."""
    b = buf.astype(np.int32)
    prev1 = np.roll(b, 1)
    prev2 = np.roll(b, 2)
    prev1[0] = 0
    prev2[:2] = 0
    c_prev = (prev1 & 0x7F) | (_ALNUM[prev2] << 7)
    return (b & 0x7F) | (c_prev << 7)


def dword_all(buf: np.ndarray) -> np.ndarray:
    """Little-endian u32 at each position (reads 3 bytes past the end, which
    the tail pad covers)."""
    b = buf.astype(np.uint32)
    return b | np.roll(b, -1) << 8 | np.roll(b, -2) << 16 | np.roll(b, -3) << 24


def match_key_all(buf: np.ndarray) -> np.ndarray:
    """Candidate grouping key: context in the high 8 bits, 23-bit
    multiplicative hash of the dword below (31 bits, a non-negative int32)."""
    h23 = ((dword_all(buf) * np.uint32(2654435761)) >> np.uint32(8)).astype(np.int64) & 0x7FFFFF
    return (cctx_all(buf).astype(np.int64) << 23) | h23
