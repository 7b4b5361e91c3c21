"""Block-data-parallel multi-stream container, copied for the port from
``orz_tpu/pcontainer.py``.

The ORZ/OTZ stream formats are sequentially state-dependent end to end, so
the parallel axis that leaves the segment format untouched is across
*independent streams*: the input is split into fixed-size segments, each
compressed self-contained with fresh model state, then framed in file
order.

Wire format (both engines):
    magic (5 bytes)
    varint(segment_size)
    repeat: varint(len(stream_i)) + stream_i      (segments, file order)
    varint(0)

ORZP magic frames orz-compatible streams of the host backends (each
decodable by the reference orz binary), 32 MiB segments by default; ORZT
magic frames OTZ segments of the device encoder (``device/pcontainer.py``,
8 MiB segments).  Here is the host path: ``pooled_segments`` encodes with
at most ``num_streams`` segments in flight on a thread pool (the native
codec releases the GIL) and never pads a short last batch;
``orz_tpu_torch/checkpoint.py`` shares it.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from orz_tpu_torch import container, trace
from orz_tpu_torch.cfg import LZCfg
from orz_tpu_torch.ioutil import CountRead, CountWrite, read_len, write_len
from orz_tpu_torch.progress import ProgressLogger, SilentProgressLogger

PARALLEL_MAGIC = b"ORZP\x01"
TPU_MAGIC = b"ORZT\x01"
MAGIC_LEN = 5
DEFAULT_SEGMENT_SIZE = 1 << 25  # 32 MiB


def read_segment(source, segment_size: int) -> bytes:
    """Up to `segment_size` bytes of `source` (fewer only at EOF)."""
    chunks = []
    remaining = segment_size
    while remaining > 0:
        piece = source.read(min(remaining, 1 << 22))
        if not piece:
            break
        chunks.append(piece)
        remaining -= len(piece)
    return b"".join(chunks)


def pooled_segments(source, encode_segment, segment_size: int,
                    num_streams: int):
    """Yield (segment length, payload) in file order: `segment_size`
    segments of `source`, each through encode_segment (bytes -> bytes) on a
    pool of `num_streams` threads, reading at most twice that many ahead."""
    workers = max(num_streams, 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = []
        eof = False
        while not eof or pending:
            while not eof and len(pending) < workers * 2:
                seg = read_segment(source, segment_size)
                if not seg:
                    eof = True
                    break
                pending.append((len(seg), pool.submit(encode_segment, seg)))
            if pending:
                seg_len, fut = pending.pop(0)
                yield seg_len, fut.result()


def frame_segments(source, target, magic: bytes, segment_size: int,
                   segments, progress: ProgressLogger | None = None) -> None:
    """Write the container: its header, then the payloads of
    segments(source), an iterator of (segment length, payload) in file
    order over a byte-counting reader, then the end mark."""
    progress = progress or SilentProgressLogger()
    progress.set_is_encode(True)
    source = CountRead(source)
    target = CountWrite(target)
    target.write(magic)
    write_len(target, segment_size)
    for _, payload in segments(source):
        with trace.span("frame"):
            write_len(target, len(payload))
            target.write(payload)
            progress.log(source.count(), target.count())
    write_len(target, 0)
    progress.finish(source.count(), target.count())


def pipe_encode(source, target, encode_segment, magic: bytes,
                segment_size: int, num_streams: int,
                progress: ProgressLogger | None = None) -> None:
    """Read segments, compress with at most `num_streams` in flight, and
    frame the payloads in file order."""
    frame_segments(source, target, magic, segment_size,
                   lambda src: pooled_segments(src, encode_segment,
                                               segment_size, num_streams),
                   progress)


def pipe_decode(source, target, decode_segment, magic: bytes,
                num_streams: int,
                progress: ProgressLogger | None = None) -> None:
    """Decode the container's segments in parallel threads (the native
    decoders release the GIL), writing them in file order."""
    progress = progress or SilentProgressLogger()
    progress.set_is_encode(False)
    source = CountRead(source)
    target = CountWrite(target)
    if source.read(MAGIC_LEN) != magic:
        raise ValueError("bad parallel container magic")
    read_len(source)  # segment_size

    with ThreadPoolExecutor(max_workers=max(num_streams, 1)) as pool:
        pending = []
        eof = False
        while not eof or pending:
            while not eof and len(pending) < max(num_streams, 1) * 2:
                n = read_len(source)
                if n == 0:
                    eof = True
                    break
                payload = source.read(n)
                if len(payload) != n:
                    raise EOFError("truncated segment")
                pending.append(pool.submit(decode_segment, payload))
            if pending:
                target.write(pending.pop(0).result())
                progress.log(source.count(), target.count())
    progress.finish(source.count(), target.count())


# --- ORZP: orz-format streams, host codec backends ---------------------------


def pencode(source, target, cfg: LZCfg, backend, num_streams: int = 4,
            segment_size: int = DEFAULT_SEGMENT_SIZE,
            progress: ProgressLogger | None = None) -> None:
    """Compress into the ORZP container with `num_streams` concurrent
    workers (native codec calls release the GIL, so threads scale on
    multi-core)."""
    pipe_encode(source, target,
                lambda seg: container.encode_bytes(seg, cfg, backend),
                PARALLEL_MAGIC, segment_size, num_streams, progress)


def pdecode(source, target, backend, num_streams: int = 4,
            progress: ProgressLogger | None = None) -> None:
    pipe_decode(source, target,
                lambda payload: container.decode_bytes(payload, backend),
                PARALLEL_MAGIC, num_streams, progress)
