"""ORZT container encode and decode on the torch port.

``torch_encode`` mirrors ``orz_tpu/device/container.py`` ``tpu_encode``:
segments stream through the port's batched chain, ``batch`` at a time,
into the ORZT container (``device/pcontainer.py``; the framing is
``pcontainer.py``'s), up to ``ORZ_INFLIGHT`` batches in flight, each
in-flight slot on its own CUDA stream.  A batch call that fails is
retried segment by segment through the per-segment staged encoder
(``device/pipeline.encode_segment_staged``), and ``ORZ_PER_SEGMENT=1``
sends every segment there, ``batch`` threads on the one device, as JAX
does.  ``torch_decode`` mirrors ``tpu_decode``: each
segment goes through the native C++ decoder built from
``csrc/otz_core.cpp`` at the repository root (the loader below is a copy
of ``orz_tpu/native/otz.py``), in parallel threads.  Where that decoder
cannot be loaded (no g++: ``OSError``; or ``ImportError``) a segment is
decoded by the sequential oracle ``device/refcodec.decode_segment_ref``
instead, as ``orz_tpu/device/container.py`` ``_decode_segment`` does, and
``decoder_fallbacks`` counts it; a failed compile and a corrupt payload
still raise.
"""

from __future__ import annotations

import ctypes
import io
import os
import threading

import numpy as np
import torch

from orz_tpu_torch import pcontainer, trace
from orz_tpu_torch.device.batch import encode_segments_batch
from orz_tpu_torch.device.host import _bucket_capacity
from orz_tpu_torch.device.pcontainer import pipe_encode
from orz_tpu_torch.device.pipeline import encode_segment_staged
from orz_tpu_torch.native import build_library
from orz_tpu_torch.pcontainer import TPU_MAGIC, pipe_decode
from orz_tpu_torch.progress import ProgressLogger
from orz_tpu_torch.spec import CHUNK_INPUT_DEFAULT

DEFAULT_SEGMENT_SIZE = 1 << 23  # 8 MiB
DEFAULT_BATCH = 4  # segments per batched device call

# Segments re-encoded one at a time through the staged encoder by
# pipe_encode's failure recovery (a failed batch call) since the last
# reset; a healthy run leaves it at 0.
segment_retries = 0
# Segments that torch_decode decoded with the sequential oracle because
# the native decoder could not be loaded, since the last reset; 0 wherever
# g++ builds csrc/otz_core.cpp.
decoder_fallbacks = 0

# The in-flight slots' streams, one per (CUDA device, slot), kept for the
# process: the caching allocator keeps a stream's freed blocks for that
# stream, so a later encode's slot reuses its earlier blocks.
_slot_streams: dict[tuple[int, int], torch.cuda.Stream] = {}
_slot_lock = threading.Lock()


def slot_streams(device: str | torch.device):
    """``pipe_encode``'s slot_init on `device`: on CUDA, each thread of the
    in-flight pool makes its slot's stream (and its device) current, so
    that the host syncs of its batch wait for that batch's work alone; None
    on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())

    def slot_init(slot: int) -> None:
        with _slot_lock:
            key = (device.index, slot)
            if key not in _slot_streams:
                _slot_streams[key] = torch.cuda.Stream(device)
        torch.cuda.set_stream(_slot_streams[key])

    return slot_init


def segment_encoders(level: int = 2, segment_size: int = DEFAULT_SEGMENT_SIZE,
                     chunk_input: int = CHUNK_INPUT_DEFAULT,
                     rings_mode: int | None = None,
                     device: str | torch.device = "cuda"):
    """(encode_batch, encode_one) for ``pipe_encode``'s loop: a batch of
    full segments shares the bucket of `segment_size` on the batched chain;
    encode_one is the per-segment retry, through the staged encoder."""
    cap = _bucket_capacity(segment_size)

    def encode_batch(segs):
        # full segments share the fixed bucket; a batch of short segments
        # only (a file's tail alone, or a sub-segment-size input) takes the
        # smaller bucket of its longest; B is the segments it is given
        c = min(cap, _bucket_capacity(max(len(s) for s in segs)))
        return encode_segments_batch(segs, level, chunk_input,
                                     rings_mode=rings_mode, cap=c,
                                     device=device)

    def encode_one(seg):
        trace.count(globals(), "segment_retries")
        return encode_segment_staged(seg, level, chunk_input,
                                     rings_mode=rings_mode, device=device)

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
    default (OTZ2 from level 2); 0/1 force OTZ1/OTZ2.  With
    ``ORZ_PER_SEGMENT=1`` each segment goes through the staged encoder
    instead, `batch` of them in flight on as many threads.  Otherwise up
    to ``ORZ_INFLIGHT`` batch calls (read at each call, default 1) run at
    once, each on a thread of its own and, on CUDA, on its slot's stream;
    at 1 they run one after another on the caller's thread and stream.
    The call is the span ``encode`` (``orz_tpu_torch.trace``)."""
    if num_streams is not None:
        if batch is not None and batch != num_streams:
            raise ValueError(f"num_streams={num_streams} and batch={batch}: "
                             f"num_streams is an alias of batch, pass one")
        batch = num_streams
    if batch is None:
        batch = DEFAULT_BATCH
    with trace.span("encode", level=level):
        if os.environ.get("ORZ_PER_SEGMENT") == "1":
            pcontainer.pipe_encode(
                source, target,
                lambda seg: encode_segment_staged(seg, level, chunk_input,
                                                  rings_mode=rings_mode,
                                                  device=device),
                TPU_MAGIC, segment_size, batch, progress)
            return
        pipe_encode(source, target,
                    *segment_encoders(level, segment_size, chunk_input,
                                      rings_mode, device),
                    TPU_MAGIC, segment_size, batch, progress,
                    slot_init=slot_streams(device))


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


def _decode_segment(payload: bytes, max_raw_len: int = 1 << 31) -> bytes:
    try:
        return decode_segment(payload, max_raw_len=max_raw_len)
    except (OSError, ImportError):  # no toolchain: slow reference fallback
        from orz_tpu_torch.device.refcodec import decode_segment_ref

        trace.count(globals(), "decoder_fallbacks")
        return decode_segment_ref(payload)


def torch_decode(source, target, num_streams: int | None = None,
                 progress: ProgressLogger | None = None) -> None:
    """Decode an ORZT container, one thread per core by default."""
    if num_streams is None:
        num_streams = os.cpu_count() or 4
    pipe_decode(source, target, _decode_segment, TPU_MAGIC, num_streams,
                progress)


def torch_decode_bytes(data: bytes, **kw) -> bytes:
    src, dst = io.BytesIO(data), io.BytesIO()
    torch_decode(src, dst, **kw)
    return dst.getvalue()
