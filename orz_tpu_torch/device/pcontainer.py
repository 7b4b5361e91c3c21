"""ORZT container framing, the device encoder's branch of
``orz_tpu/pcontainer.py`` ``pipe_encode`` (TPU_MAGIC), copied for the port.

The wire format, the byte counters, the length varints and the decode loop
are the host container's (``orz_tpu_torch/pcontainer.py``,
``orz_tpu_torch/ioutil.py``).  ``pipe_encode`` here is the original's
batched branch: segments are read ``batch`` at a time and encoded by one
``encode_batch`` call, one batch in flight (the original's default); an
EOF leftover batch is padded with copies of its first segment and the
padding's payloads are dropped, so that it reuses the batch's shapes.  A
batch call that raises is retried segment by segment through
``encode_one``.  ``encoded_segments`` is that loop, which
``orz_tpu_torch/checkpoint.py`` shares.  ``tests/test_torch_host.py`` holds
the bytes to the original's.
"""

from __future__ import annotations

from orz_tpu_torch.pcontainer import frame_segments, read_segment
from orz_tpu_torch.progress import ProgressLogger


def encoded_segments(source, encode_batch, encode_one, segment_size: int,
                     batch: int):
    """Yield (segment length, payload) in file order: `segment_size`
    segments read `batch` at a time and encoded by one encode_batch call."""
    bsz = max(batch, 1)
    eof = False
    while not eof:
        segs = []
        while len(segs) < bsz:
            seg = read_segment(source, segment_size)
            if not seg:
                eof = True
                break
            segs.append(seg)
        if not segs:
            break
        k = len(segs)
        try:
            payloads = encode_batch(segs + [segs[0]] * (bsz - k))[:k]
        except Exception:
            # recovery at segment granularity: a failed batch call (device
            # out of memory, a transient error) re-encodes its segments one
            # at a time; a second failure propagates
            payloads = [encode_one(s) for s in segs]
        yield from zip((len(s) for s in segs), payloads)


def pipe_encode(source, target, encode_batch, encode_one, magic: bytes,
                segment_size: int, batch: int,
                progress: ProgressLogger | None = None) -> None:
    """Read `segment_size` segments, encode `batch` per encode_batch call,
    and frame the payloads in file order."""
    frame_segments(source, target, magic, segment_size,
                   lambda src: encoded_segments(src, encode_batch, encode_one,
                                                segment_size, batch),
                   progress)
