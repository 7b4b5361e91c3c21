"""ORZT container encode and decode on the torch port.

``torch_encode`` mirrors ``orz_tpu/device/container.py`` ``tpu_encode``:
segments stream through the port's batched chain, ``batch`` at a time,
into the ORZT container (``device/pcontainer.py``; the framing is
``pcontainer.py``'s).  ``torch_decode`` mirrors ``tpu_decode``: each
segment goes through the native C++ decoder built from
``csrc/otz_core.cpp`` at the repository root (the loader below is a copy
of ``orz_tpu/native/otz.py``), in parallel threads.
"""

from __future__ import annotations

import ctypes
import io
import os
import threading

import numpy as np
import torch

from orz_tpu_torch.device.batch import encode_segments_batch
from orz_tpu_torch.device.host import _bucket_capacity
from orz_tpu_torch.device.pcontainer import pipe_encode
from orz_tpu_torch.native import build_library
from orz_tpu_torch.pcontainer import TPU_MAGIC, pipe_decode
from orz_tpu_torch.progress import ProgressLogger
from orz_tpu_torch.spec import CHUNK_INPUT_DEFAULT

DEFAULT_SEGMENT_SIZE = 1 << 23  # 8 MiB
DEFAULT_BATCH = 4  # segments per batched device call

# Segments re-encoded one at a time by pipe_encode's failure recovery (a
# failed batch call) since the last reset; a healthy run leaves it at 0.
segment_retries = 0


def segment_encoders(level: int = 2, segment_size: int = DEFAULT_SEGMENT_SIZE,
                     chunk_input: int = CHUNK_INPUT_DEFAULT,
                     rings_mode: int | None = None,
                     device: str | torch.device = "cuda"):
    """(encode_batch, encode_one) of the batched chain, for
    ``pipe_encode``'s loop: a batch of full segments shares the bucket of
    `segment_size`; encode_one is the per-segment retry (B=1)."""
    cap = _bucket_capacity(segment_size)

    def encode_batch(segs):
        # full segments share the fixed bucket; a short leftover batch (or a
        # sub-segment-size input) takes its own smaller bucket
        c = min(cap, _bucket_capacity(max(len(s) for s in segs)))
        return encode_segments_batch(segs, level, chunk_input,
                                     rings_mode=rings_mode, cap=c,
                                     device=device)

    def encode_one(seg):
        global segment_retries
        segment_retries += 1
        return encode_segments_batch([seg], level, chunk_input,
                                     rings_mode=rings_mode, device=device)[0]

    return encode_batch, encode_one


def torch_encode(
    source,
    target,
    level: int = 2,
    num_streams: int | None = None,  # alias for `batch` (CLI -p)
    segment_size: int = DEFAULT_SEGMENT_SIZE,
    chunk_input: int = CHUNK_INPUT_DEFAULT,
    batch: int | None = None,  # default DEFAULT_BATCH
    progress: ProgressLogger | None = None,
    rings_mode: int | None = None,
    device: str | torch.device = "cuda",
) -> None:
    """Stream-encode into the ORZT container, `batch` segments per device
    call; the arguments are ``tpu_encode``'s, and `num_streams` is an alias
    for `batch` (pass one of the two).  rings_mode: None = the level's
    default (OTZ2 from level 2); 0/1 force OTZ1/OTZ2."""
    if num_streams is not None:
        if batch is not None and batch != num_streams:
            raise ValueError(f"num_streams={num_streams} and batch={batch}: "
                             f"num_streams is an alias of batch, pass one")
        batch = num_streams
    if batch is None:
        batch = DEFAULT_BATCH
    pipe_encode(source, target,
                *segment_encoders(level, segment_size, chunk_input,
                                  rings_mode, device),
                TPU_MAGIC, segment_size, batch, progress)


def torch_encode_bytes(data: bytes, level: int = 2, **kw) -> bytes:
    src, dst = io.BytesIO(data), io.BytesIO()
    torch_encode(src, dst, level=level, **kw)
    return dst.getvalue()


# --- the native segment decoder (orz_tpu/native/otz.py) ----------------------

_DECODER_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "csrc", "otz_core.cpp")

_decoder = None
_decoder_lock = threading.Lock()


def decoder_library():
    """The native decoder (built with g++ on first call)."""
    global _decoder
    with _decoder_lock:
        if _decoder is None:
            lib = ctypes.CDLL(build_library(_DECODER_SRC, "libotz_core"))
            lib.otz_raw_len.restype = ctypes.c_int64
            lib.otz_raw_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.otz_decode_segment.restype = ctypes.c_int64
            lib.otz_decode_segment.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64,
            ]
            _decoder = lib
    return _decoder


def decode_segment(payload: bytes, max_raw_len: int = 1 << 31) -> bytes:
    """One OTZ segment payload -> its bytes.  max_raw_len caps the size a
    header may claim."""
    lib = decoder_library()
    src = np.frombuffer(payload, dtype=np.uint8)
    raw_len = lib.otz_raw_len(src.ctypes.data, src.size)
    if raw_len < 0 or raw_len > max_raw_len:
        raise ValueError("invalid OTZ segment header")
    if raw_len == 0:
        return b""
    dst = np.empty(raw_len, dtype=np.uint8)
    rc = lib.otz_decode_segment(src.ctypes.data, src.size, dst.ctypes.data,
                                dst.size)
    if rc < 0:
        raise ValueError(f"invalid OTZ segment (native decoder error {rc})")
    return dst.tobytes()


def torch_decode(source, target, num_streams: int | None = None,
                 progress: ProgressLogger | None = None) -> None:
    """Decode an ORZT container, one thread per core by default."""
    if num_streams is None:
        num_streams = os.cpu_count() or 4
    pipe_decode(source, target, decode_segment, TPU_MAGIC, num_streams,
                progress)


def torch_decode_bytes(data: bytes, **kw) -> bytes:
    src, dst = io.BytesIO(data), io.BytesIO()
    torch_decode(src, dst, **kw)
    return dst.getvalue()
