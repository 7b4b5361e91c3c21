"""Host-side names the port needs from JAX-importing modules, copied.

Each name below lives in a module of the JAX package that imports jax at
load time (``orz_tpu/device/pipeline.py``, ``orz_tpu/ops/analyze.py``,
``orz_tpu/ops/symrank_pallas.py``), so the port carries a copy instead of
importing it; ``tests/test_torch_host.py`` asserts that every copy equals
its original.  ``pad_batch`` is the one helper both packages' tests feed:
it builds the padded ``(B, PAD_FRONT + cap + PAD_TAIL)`` buffer that
crosses between them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from orz_tpu_torch.bitio import BitEncoder
from orz_tpu_torch.spec import (
    PAD_FRONT,
    PAD_TAIL,
    SYMRANK_NUM_SYMBOLS,
    TABC_SIZE,
    n_chunks_for,
)

N_SYM = SYMRANK_NUM_SYMBOLS

# orz_tpu/ops/analyze.py
LCP0 = 64  # sort-payload LCP window in bytes
N_DW = LCP0 // 4
EXT_W = 32  # bytes compared per extension round

# orz_tpu/ops/symrank_pallas.py
C = 512  # symrank contexts
C_MID = 128
S = SYMRANK_NUM_SYMBOLS  # 431
S_PAD = -(-S // 8) * 8  # 432
TOP = S - 1
R_CAP_MAX = 1 << 20

# orz_tpu/device/pipeline.py
_FETCH_GRANULE = 1 << 14  # words (64 KiB): word-fetch slice size bucket


class SegmentOut(NamedTuple):
    """Per-batch device outputs: ``meta`` carries every scalar and table,
    ``words`` the flat payload the host slices by meta's word counts.

    meta layout (int32): [num_counted, pred_len, n_items, total_words,
    chunk_items(C), bitlen(C), word_base(C), census_order(N_SYM),
    lensA(C*N_SYM), lensB(C*N_SYM), lensC(C*N_SYM)].
    """

    meta: object
    words: object


def _w_total(c_max: int, chunk_input: int) -> int:
    # worst case ~15 bits per input byte (all rare literals); +margin
    return (c_max * chunk_input) // 2 + 64 * c_max


def _bucket_capacity(n: int) -> int:
    """Segment-length bucket."""
    cap = 1 << 12
    while cap < n:
        cap *= 2
    return cap


def _bucket(n: int, lo: int, factor: int = 4) -> int:
    """Power-of-`factor` shape bucket starting at `lo`."""
    cap = lo
    while cap < n:
        cap *= factor
    return cap


def assemble_segment_np(enc: BitEncoder, meta: np.ndarray, words: np.ndarray,
                        raw_len: int, chunk_input: int,
                        rings_mode: int = 0) -> bytes:
    """Segment stream assembly over host-resident meta/words arrays."""
    c_max = (meta.shape[0] - 4 - N_SYM) // (3 + 3 * N_SYM)
    num_counted, pred_len, _n_items, total_words = (int(v) for v in meta[:4])
    o = 4
    chunk_items = meta[o : o + c_max]; o += c_max
    bitlen = meta[o : o + c_max]; o += c_max
    word_base = meta[o : o + c_max]; o += c_max
    order = meta[o : o + N_SYM]; o += N_SYM
    lensA = meta[o : o + c_max * N_SYM].reshape(c_max, N_SYM); o += c_max * N_SYM
    lensB = meta[o : o + c_max * N_SYM].reshape(c_max, N_SYM); o += c_max * N_SYM
    lensC = meta[o : o + c_max * N_SYM].reshape(c_max, N_SYM)

    enc.encode_raw_bits(pred_len, 1)  # prediction flag
    enc.encode_raw_bits(rings_mode, 1)  # ring insertion rule (spec.py OTZ2)
    # word-table update rule (refcodec header): OTZ2 couples item-end
    # word sampling with item-start rings; OTZ1 keeps the bytes-only rule
    enc.encode_raw_bits(rings_mode, 1)
    enc.encode_varint(num_counted)
    for s in order[:num_counted]:
        enc.encode_raw_bits(int(s), 9)

    n_chunks = n_chunks_for(raw_len, chunk_input)
    for k in range(n_chunks):
        enc.encode_varint(int(chunk_items[k]))
        enc.encode_huffman_table(lensA[k].tolist())
        enc.encode_huffman_table(lensB[k].tolist())
        enc.encode_huffman_table(lensC[k, :TABC_SIZE].tolist())
        nw = (int(bitlen[k]) + 31) // 32
        base = int(word_base[k])
        enc.append_bits_bulk(words[base : base + nw], int(bitlen[k]))
    return enc.finish()


def pad_batch(datas: list[bytes], cap: int) -> tuple[np.ndarray, np.ndarray]:
    """(bufs, seg_lens): the zero-padded ``(B, PAD_FRONT + cap + PAD_TAIL)``
    uint8 batch buffer (as ``orz_tpu/device/batch.py`` ``_pad_batch``
    builds it) and the int32 segment lengths."""
    arr = np.zeros((len(datas), PAD_FRONT + cap + PAD_TAIL), dtype=np.uint8)
    for i, d in enumerate(datas):
        arr[i, PAD_FRONT : PAD_FRONT + len(d)] = np.frombuffer(d, np.uint8)
    return arr, np.array([len(d) for d in datas], np.int32)
