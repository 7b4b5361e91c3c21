"""ORZT container encode on the torch port.

``torch_encode`` mirrors ``orz_tpu/device/container.py`` ``tpu_encode`` on
the shared ``orz_tpu.pcontainer.pipe_encode``: segments stream through the
port's batched OTZ1 chain, ``batch`` at a time.  The stream is the same
ORZT container, so decode stays the shared native decoder
(``orz_tpu.device.container.tpu_decode`` / ``tpu_decode_bytes``).
"""

from __future__ import annotations

import io

import torch

from orz_tpu.device.container import tpu_decode, tpu_decode_bytes
from orz_tpu.device.spec import CHUNK_INPUT_DEFAULT
from orz_tpu.pcontainer import TPU_MAGIC, pipe_encode
from orz_tpu.progress import ProgressLogger
from orz_tpu_torch.device.batch import encode_segments_batch
from orz_tpu_torch.device.host import _bucket_capacity

__all__ = ["torch_encode", "torch_encode_bytes",
           "tpu_decode", "tpu_decode_bytes"]  # decode: the shared decoder

DEFAULT_SEGMENT_SIZE = 1 << 23  # 8 MiB
DEFAULT_BATCH = 4  # segments per batched device call

# Segments re-encoded one at a time by pipe_encode's failure recovery (a
# failed batch call) since the last reset; a healthy run leaves it at 0.
segment_retries = 0


def torch_encode(
    source,
    target,
    level: int = 1,
    segment_size: int = DEFAULT_SEGMENT_SIZE,
    chunk_input: int = CHUNK_INPUT_DEFAULT,
    batch: int = DEFAULT_BATCH,
    progress: ProgressLogger | None = None,
    rings_mode: int | None = None,
    device: str | torch.device = "cuda",
) -> None:
    """Stream-encode into the ORZT container, `batch` segments per device
    call.  Level 2 with OTZ2 on (rings_mode=1) is the port's l2 slice and
    raises NotImplementedError until it lands."""
    batch = max(batch, 1)
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

    pipe_encode(source, target, encode_one, TPU_MAGIC, segment_size, batch,
                progress, encode_batch=encode_batch, batch_size=batch)


def torch_encode_bytes(data: bytes, level: int = 1, **kw) -> bytes:
    src, dst = io.BytesIO(data), io.BytesIO()
    torch_encode(src, dst, level=level, **kw)
    return dst.getvalue()
