"""The plain reference decoder against the program's l2 encodes of a tiny
Silesia mix on the CPU, every kind, each file its own call: on the normal
route, with segments sent to the OTZ1 fallback, and with batches sent whole
to the staged encoder; then the tiny cell through the harness.  Tolerance
0 bytes."""

import os
import time

import pytest

import tiny
import tiny_silesia

torch = pytest.importorskip("torch")
import harness  # noqa: E402
import otz  # noqa: E402

SCHEDULE = "96x1,384x2"  # reaches every l2 stage in a quarter of the steps
SKEW_CAP = 64  # R_CAP_MAX low enough that text is past it


@pytest.fixture(scope="module")
def files():
    g = harness.load_module(os.path.join(tiny.PB, "gen", "silesia.py"), "g_silesia")
    return g.make(2 ** 31 + 3, tiny_silesia.TINY_SILESIA).objects


@pytest.fixture
def encode(monkeypatch):
    from orz_tpu_torch.device.container import torch_encode_bytes

    monkeypatch.setenv("OTZ2_SCHEDULE", SCHEDULE)
    return lambda data: torch_encode_bytes(data, level=2, device="cpu",
                                           segment_size=8192, batch=2)


def decodes(stream: bytes, data: bytes) -> None:
    seg, payloads = otz.read_container(stream)
    assert seg == 8192 and len(payloads) == -(-len(data) // seg)
    assert b"".join(otz.decode_segment(p) for p in payloads) == data


def test_every_kind_decodes(files, encode):
    for data in files:
        decodes(encode(data), data)


def test_otz1_fallback_segments_decode(files, encode, monkeypatch):
    """The first segment of every batch fails its repair and is re-encoded
    through OTZ1 inside the l2 stream."""
    from orz_tpu_torch.device import batch as tb

    mid2 = tb.mid2_body

    def fail_first(*args, **kw):
        items, ok, *rest = mid2(*args, **kw)
        ok = ok.clone()
        ok[0] = False
        return (items, ok, *rest)

    monkeypatch.setattr(tb, "mid2_body", fail_first)
    before = tb.otz1_fallbacks
    for data in files[:3]:  # dickens, mozilla (3 segments), mr (2)
        decodes(encode(data), data)
    assert tb.otz1_fallbacks - before == 4  # one a batch: 1 + 2 + 1 batches


def test_staged_batches_decode(files, encode, monkeypatch):
    """R_CAP_MAX lowered: the skew check sends each batch of the text
    files whole to the staged encoder."""
    from orz_tpu_torch.device import batch as tb
    from orz_tpu_torch.device import host

    monkeypatch.setattr(host, "R_CAP_MAX", SKEW_CAP)
    batches, segs = tb.staged_batches, tb.staged_segments
    for data in (files[0], files[9]):  # dickens, webster: one segment each
        decodes(encode(data), data)
    assert tb.staged_batches - batches == 2
    assert tb.staged_segments - segs == 4  # each padded to the batch of 2


def test_tiny_cell_through_the_harness(tmp_path):
    """The tiny Silesia cell, traced: correct, with the slot counters read."""
    root = tiny_silesia.make_root(str(tmp_path))
    res = harness.run_cell("tiny-silesia-l2", 2 ** 31 + 41, 0.1, True, time.perf_counter(),
                           device="cpu", root=root, check_workers=0)
    assert res["correct"] is True and res["attempted"] >= 6 and res["failed"] == 0
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert 0 < m["pad_share"] < 100 and m["staged_segments"] >= 0
    assert m["otz1_fallbacks"] >= 0 and 0 < m["stage_share.QUALITY"] < 100
