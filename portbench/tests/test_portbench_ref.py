"""The plain reference decoder against the program's own encodes on the
CPU, and on streams with a changed byte."""

import os
import random

import pytest

import tiny

torch = pytest.importorskip("torch")
import otz  # noqa: E402
from harness import load_module  # noqa: E402


@pytest.fixture(scope="module")
def streams():
    from orz_tpu_torch.device.container import torch_encode_bytes

    g = load_module(os.path.join(tiny.PB, "gen", "canterbury.py"), "g_canterbury")
    src = g.make(2 ** 31 + 3, tiny.TINY_CANTERBURY)
    data = b"".join(src.objects)
    assert 16384 < len(data) <= 24576
    os.environ["OTZ2_SCHEDULE"] = "96x1,384x2"
    try:
        out = {lv: torch_encode_bytes(data, level=lv, device="cpu", segment_size=8192,
                                      batch=2) for lv in (1, 2)}
    finally:
        del os.environ["OTZ2_SCHEDULE"]
    return data, out


@pytest.mark.parametrize("level", [1, 2])
def test_decodes_the_programs_streams(streams, level):
    data, out = streams
    seg, payloads = otz.read_container(out[level])
    assert seg == 8192 and len(payloads) == 3
    assert b"".join(otz.decode_segment(p) for p in payloads) == data
    assert [otz.segment_header(p)[0] for p in payloads] == [8192, 8192, len(data) - 16384]
    pre = otz.decode_segment(payloads[1], limit=1000)
    assert 1000 <= len(pre) and data[8192:8192 + len(pre)] == pre


@pytest.mark.parametrize("level", [1, 2])
def test_changed_bytes_never_pass(streams, level):
    data, out = streams
    _, payloads = otz.read_container(out[level])
    r = random.Random(level)
    for _ in range(40):
        p = bytearray(payloads[0])
        at = r.randrange(len(p))
        p[at] ^= 1 << r.randrange(8)
        try:
            got = otz.decode_segment(bytes(p))
        except Exception:
            continue
        # a flip in the padding bits of the last word may leave the bytes
        assert got != data[:8192] or at >= len(p) - 4


def test_container_framing_errors(streams):
    _, out = streams
    s = out[1]
    for bad in (b"ORZX" + s[4:], s[:-1], s + b"\0"):
        with pytest.raises(otz.FormatError):
            otz.read_container(bad)
