"""Checkpoint/resume for the port's ORZT encodes.

The sidecar of ``orz_tpu/checkpoint.py``, copied: each ORZT segment is
self-contained, so the resumable state is (source offset, target offset,
segments written), saved as JSON (atomic rename) after every flushed
segment.  A resumed encode validates the sidecar against (magic,
segment_size), truncates the target back to the saved offset, seeks the
source, and continues; the sidecar is removed on success.

Unlike the original, which takes a per-segment encoder, segments go through
the port's batched chain, ``batch`` per ``encode_segments_batch`` call, in
the same loop as ``torch_encode`` (``pcontainer.encoded_segments``).  A
segment's bytes do not depend on the segments that share its batch call,
so a fresh file, or one resumed in the middle of a batch, is
byte-identical to ``torch_encode``'s.

    python -m orz_tpu_torch.cli encode --checkpoint STATE.json in out
"""

from __future__ import annotations

import json
import os

import torch

from orz_tpu_torch.device.container import (
    DEFAULT_BATCH,
    DEFAULT_SEGMENT_SIZE,
    segment_encoders,
)
from orz_tpu_torch.device.pcontainer import (
    TPU_MAGIC,
    CountRead,
    encoded_segments,
    write_len,
)
from orz_tpu_torch.progress import ProgressLogger, SilentProgressLogger

_FORMAT = 1


class CheckpointState:
    """Sidecar save/load; all offsets are absolute file positions."""

    def __init__(self, path: str):
        self.path = path

    def save(self, magic: bytes, segment_size: int, src_off: int,
             dst_off: int, n_segments: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "format": _FORMAT,
                "magic": magic.hex(),
                "segment_size": segment_size,
                "src_off": src_off,
                "dst_off": dst_off,
                "n_segments": n_segments,
            }, f)
        os.replace(tmp, self.path)

    def load(self) -> dict | None:
        try:
            with open(self.path) as f:
                st = json.load(f)
        except (OSError, ValueError):
            return None
        if st.get("format") != _FORMAT:
            return None
        return st

    def clear(self) -> None:
        try:
            os.remove(self.path)
        except OSError:
            pass


def checkpointed_encode(
    source_path: str,
    target_path: str,
    checkpoint_path: str,
    level: int = 2,
    batch: int = DEFAULT_BATCH,
    segment_size: int = DEFAULT_SEGMENT_SIZE,
    progress: ProgressLogger | None = None,
    device: str | torch.device = "cuda",
) -> None:
    """``torch_encode`` from one file into another with segment-granular
    resume through the sidecar at `checkpoint_path`."""
    progress = progress or SilentProgressLogger()
    progress.set_is_encode(True)
    ck = CheckpointState(checkpoint_path)
    st = ck.load()
    resume = (
        st is not None
        and st["magic"] == TPU_MAGIC.hex()
        and st["segment_size"] == segment_size
        and os.path.exists(target_path)
        and os.path.getsize(target_path) >= st["dst_off"]
    )

    with open(source_path, "rb") as src_f, \
            open(target_path, "r+b" if resume else "wb") as dst_f:
        if resume:
            src_off, n_segments = st["src_off"], st["n_segments"]
            src_f.seek(src_off)
            dst_f.truncate(st["dst_off"])
            dst_f.seek(st["dst_off"])
        else:
            src_off, n_segments = 0, 0
            dst_f.write(TPU_MAGIC)
            write_len(dst_f, segment_size)
            ck.save(TPU_MAGIC, segment_size, 0, dst_f.tell(), 0)
        source = CountRead(src_f)
        dst_start = st["dst_off"] if resume else 0  # this run's output
        for seg_len, payload in encoded_segments(
                source, *segment_encoders(level, segment_size, device=device),
                segment_size, batch):
            write_len(dst_f, len(payload))
            dst_f.write(payload)
            dst_f.flush()
            # the source offset of the next unwritten segment: the batch
            # read ahead of it is encoded again on resume
            src_off += seg_len
            n_segments += 1
            ck.save(TPU_MAGIC, segment_size, src_off, dst_f.tell(),
                    n_segments)
            progress.log(source.count(), dst_f.tell() - dst_start)
        write_len(dst_f, 0)
        progress.finish(source.count(), dst_f.tell() - dst_start)
    ck.clear()
