"""Byte-counting stream wrappers and chunk-length framing, copied for the
port from ``orz_tpu/ioutil.py``.

Mirrors reference src/ioutil.rs: `CountRead`/`CountWrite` (ioutil.rs:9-50) and
the byte-oriented base-128 varint used for chunk framing (ioutil.rs:52-89).
Note this is a *different* varint from the in-bitstream 2-bit-group varint in
the entropy coder (see golden/bitio.py).
"""

from __future__ import annotations

import io
from typing import BinaryIO


class CountRead:
    """Wraps a readable binary stream, counting bytes read."""

    def __init__(self, inner: BinaryIO):
        self.inner = inner
        self._count = 0

    def read(self, n: int = -1) -> bytes:
        data = self.inner.read(n)
        self._count += len(data)
        return data

    def readinto(self, buf) -> int:
        if hasattr(self.inner, "readinto"):
            n = self.inner.readinto(buf)
            if n is None:
                n = 0
        else:
            data = self.inner.read(len(buf))
            n = len(data)
            buf[:n] = data
        self._count += n
        return n

    def count(self) -> int:
        return self._count


class CountWrite:
    """Wraps a writable binary stream, counting bytes written."""

    def __init__(self, inner: BinaryIO):
        self.inner = inner
        self._count = 0

    def write(self, data) -> int:
        self.inner.write(data)
        self._count += len(data)
        return len(data)

    def flush(self) -> None:
        self.inner.flush()

    def count(self) -> int:
        return self._count


def read_repeatedly(source, buf: memoryview) -> int:
    """Read until EOF or until buf is filled (reference src/lib.rs:42-52)."""
    result = 0
    view = memoryview(buf)
    while result < len(view):
        if hasattr(source, "readinto"):
            n = source.readinto(view[result:])
        else:
            data = source.read(len(view) - result)
            n = len(data)
            view[result : result + n] = data
        if not n:
            break
        result += n
    return result


def write_len(target, length: int) -> None:
    """Byte-oriented base-128 varint framing (reference src/ioutil.rs:79-88).

    Low digits first; continuation marked by the 128 bit on all but the last
    byte.
    """
    out = bytearray()
    while length >= 128:
        out.append(128 + (length % 128))
        length //= 128
    out.append(length)
    target.write(bytes(out))


def read_len(source) -> int:
    """Inverse of write_len (reference src/ioutil.rs:60-76).

    Raises EOFError on truncated input.
    """
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


def encode_len_bytes(length: int) -> bytes:
    buf = io.BytesIO()
    write_len(buf, length)
    return buf.getvalue()
