"""ORZT container framing, copied for the port.

The wire format of ``orz_tpu/pcontainer.py`` (TPU_MAGIC), with the byte
counters and length varints of ``orz_tpu/ioutil.py`` (reference
src/ioutil.rs); the progress interface is ``orz_tpu_torch/progress.py``:

    magic (5 bytes)
    varint(segment_size)
    repeat: varint(len(stream_i)) + stream_i      (segments, file order)
    varint(0)

``pipe_encode`` is the batched branch of the original: segments are read
``batch`` at a time and encoded by one ``encode_batch`` call, one batch in
flight (the original's default); an EOF leftover batch is padded with
copies of its first segment and the padding's payloads are dropped.  A
batch call that raises is retried segment by segment through
``encode_one``.  ``encoded_segments`` is that loop, which
``orz_tpu_torch/checkpoint.py`` shares.  ``tests/test_torch_host.py`` holds
the bytes to the original's.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from orz_tpu_torch.progress import ProgressLogger, SilentProgressLogger

TPU_MAGIC = b"ORZT\x01"
PARALLEL_MAGIC = b"ORZP\x01"  # the host backends' container (not ported)
MAGIC_LEN = 5


class CountRead:
    """Wraps a readable binary stream, counting bytes read."""

    def __init__(self, inner):
        self.inner = inner
        self._count = 0

    def read(self, n: int = -1) -> bytes:
        data = self.inner.read(n)
        self._count += len(data)
        return data

    def count(self) -> int:
        return self._count


class CountWrite:
    """Wraps a writable binary stream, counting bytes written."""

    def __init__(self, inner):
        self.inner = inner
        self._count = 0

    def write(self, data) -> int:
        self.inner.write(data)
        self._count += len(data)
        return len(data)

    def count(self) -> int:
        return self._count


def write_len(target, length: int) -> None:
    """Byte-oriented base-128 varint, low digits first (reference
    src/ioutil.rs:79-88)."""
    out = bytearray()
    while length >= 128:
        out.append(128 + (length % 128))
        length //= 128
    out.append(length)
    target.write(bytes(out))


def read_len(source) -> int:
    """Inverse of write_len; raises EOFError on truncated input."""
    length = 0
    factor = 1
    while True:
        b = source.read(1)
        if len(b) != 1:
            raise EOFError("truncated length prefix")
        v = b[0]
        if v < 128:
            length += v * factor
            break
        length += (v - 128) * factor
        factor *= 128
    return length


def _read_segment(source, segment_size: int) -> bytes:
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


def encoded_segments(source, encode_batch, encode_one, segment_size: int,
                     batch: int):
    """Yield (segment length, payload) in file order: `segment_size`
    segments read `batch` at a time and encoded by one encode_batch call."""
    bsz = max(batch, 1)
    eof = False
    while not eof:
        segs = []
        while len(segs) < bsz:
            seg = _read_segment(source, segment_size)
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
    progress = progress or SilentProgressLogger()
    progress.set_is_encode(True)
    source = CountRead(source)
    target = CountWrite(target)
    target.write(magic)
    write_len(target, segment_size)
    for _, payload in encoded_segments(source, encode_batch, encode_one,
                                       segment_size, batch):
        write_len(target, len(payload))
        target.write(payload)
        progress.log(source.count(), target.count())
    write_len(target, 0)
    progress.finish(source.count(), target.count())


def pipe_decode(source, target, decode_segment, magic: bytes,
                num_streams: int,
                progress: ProgressLogger | None = None) -> None:
    """Decode the container's segments in parallel threads (the native
    decoder releases the GIL), writing them in file order."""
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
