"""Streaming container layer of the orz-compatible stream (reference
src/lib.rs:58-129), copied for the port from ``orz_tpu/container.py``.

Frames chunks with byte-oriented base-128 varint lengths, slides the 32MB
window keeping a 16MB prematch region, and terminates the stream with a
zero-length chunk.

The codec itself is supplied as a *backend* so the same container drives the
golden Python model and the native C++ codec.  A backend provides:

    enc = backend.new_encoder(cfg)
      enc.encode_chunk(sbuf, sbuf_len, spos) -> (new_spos, payload_bytes)
      enc.forward(n)
    dec = backend.new_decoder()
      dec.decode_chunk(tbuf, sbuf, sbuf_cap, spos) -> new_spos
      dec.forward(n)

where sbuf is a numpy uint8 buffer physically padded with SBVEC_SENTINEL_LEN
zero bytes at both ends plus slack for decoder overwrites.
"""

from __future__ import annotations

import numpy as np

from orz_tpu_torch.cfg import LZCfg
from orz_tpu_torch.constants import (
    LZ_BLOCK_FRESH_LEN,
    LZ_BLOCK_SIZE,
    LZ_TBUF_CAPACITY,
    SBVEC_PREMATCH_LEN,
    SBVEC_SENTINEL_LEN,
)
from orz_tpu_torch.ioutil import CountRead, CountWrite, read_len, read_repeatedly, write_len
from orz_tpu_torch.progress import ProgressLogger, SilentProgressLogger

# extra slack past the logical window: sentinel + room for the decoder's
# dword-granular copy overshoot
_PAD = SBVEC_SENTINEL_LEN + 64


def _window_buffer() -> np.ndarray:
    """The sliding window with sentinel padding on both sides.  The returned
    array is the *logical* window; negative/overflow reads from the codec hit
    the zero sentinels of the backing buffer."""
    backing = np.zeros(LZ_BLOCK_SIZE + 2 * _PAD, dtype=np.uint8)
    return backing[_PAD : _PAD + LZ_BLOCK_SIZE + _PAD]  # keep tail slack visible


def encode(source, target, cfg: LZCfg, backend, progress: ProgressLogger | None = None) -> None:
    """Compress source into an ORZ stream on target (reference src/lib.rs:58-92)."""
    progress = progress or SilentProgressLogger()
    progress.set_is_encode(True)
    if not isinstance(source, CountRead):
        source = CountRead(source)
    if not isinstance(target, CountWrite):
        target = CountWrite(target)

    enc = backend.new_encoder(cfg)
    sbvec = _window_buffer()

    while True:
        fresh_view = memoryview(sbvec.data)[SBVEC_PREMATCH_LEN : SBVEC_PREMATCH_LEN + LZ_BLOCK_FRESH_LEN]
        read_size = read_repeatedly(source, fresh_view)
        if read_size == 0:
            break
        sbuf_len = SBVEC_PREMATCH_LEN + read_size
        spos = SBVEC_PREMATCH_LEN
        while spos < sbuf_len:
            spos, payload = enc.encode_chunk(sbvec, sbuf_len, spos)
            write_len(target, len(payload))
            target.write(payload)
        # slide the window: carry the last PREMATCH bytes of the full window
        # to the front (reference src/lib.rs:83-84)
        sbvec[:SBVEC_PREMATCH_LEN] = sbvec[LZ_BLOCK_SIZE - SBVEC_PREMATCH_LEN : LZ_BLOCK_SIZE]
        enc.forward(LZ_BLOCK_SIZE - SBVEC_PREMATCH_LEN)
        progress.log(source.count(), target.count())

    write_len(target, 0)  # EOF marker
    progress.finish(source.count(), target.count())


def decode(source, target, backend, progress: ProgressLogger | None = None) -> None:
    """Decompress an ORZ stream (reference src/lib.rs:94-129)."""
    progress = progress or SilentProgressLogger()
    progress.set_is_encode(False)
    if not isinstance(source, CountRead):
        source = CountRead(source)
    if not isinstance(target, CountWrite):
        target = CountWrite(target)

    dec = backend.new_decoder()
    sbvec = _window_buffer()
    spos = SBVEC_PREMATCH_LEN

    while True:
        t = read_len(source)
        if t == 0:
            break
        if t >= LZ_TBUF_CAPACITY:
            raise ValueError("invalid chunk length")
        tbuf = source.read(t)
        if len(tbuf) != t:
            raise EOFError("truncated chunk")

        spos_end = dec.decode_chunk(tbuf, sbvec, LZ_BLOCK_SIZE, spos)
        target.write(sbvec[spos:spos_end].tobytes())
        spos = spos_end

        if spos >= LZ_BLOCK_SIZE:
            sbvec[:SBVEC_PREMATCH_LEN] = sbvec[LZ_BLOCK_SIZE - SBVEC_PREMATCH_LEN : LZ_BLOCK_SIZE]
            dec.forward(LZ_BLOCK_SIZE - SBVEC_PREMATCH_LEN)
            progress.log(source.count(), target.count())
            spos = SBVEC_PREMATCH_LEN

    progress.finish(source.count(), target.count())


class GoldenBackend:
    """Backend over the golden (reference-exact, slow) Python model."""

    @staticmethod
    def new_encoder(cfg: LZCfg):
        from orz_tpu_torch.golden.lz import GoldenLZEncoder

        return _GoldenEnc(GoldenLZEncoder(), cfg)

    @staticmethod
    def new_decoder():
        from orz_tpu_torch.golden.lz import GoldenLZDecoder

        return _GoldenDec(GoldenLZDecoder())


class _GoldenEnc:
    def __init__(self, inner, cfg):
        self.inner = inner
        self.cfg = cfg

    def encode_chunk(self, sbuf, sbuf_len, spos):
        return self.inner.encode_chunk(self.cfg, sbuf, sbuf_len, spos)

    def forward(self, n):
        self.inner.forward(n)


class _GoldenDec:
    def __init__(self, inner):
        self.inner = inner

    def decode_chunk(self, tbuf, sbuf, sbuf_cap, spos):
        return self.inner.decode_chunk(tbuf, sbuf, sbuf_cap, spos)

    def forward(self, n):
        self.inner.forward(n)


def encode_bytes(data: bytes, cfg: LZCfg, backend) -> bytes:
    """Convenience one-shot encode."""
    import io

    src, dst = io.BytesIO(data), io.BytesIO()
    encode(src, dst, cfg, backend)
    return dst.getvalue()


def decode_bytes(data: bytes, backend) -> bytes:
    """Convenience one-shot decode."""
    import io

    src, dst = io.BytesIO(data), io.BytesIO()
    decode(src, dst, backend)
    return dst.getvalue()
