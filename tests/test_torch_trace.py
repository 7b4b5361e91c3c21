"""The port's spans and counters (``orz_tpu_torch/trace.py``) on the CPU.

Spans are off by default and then record nothing; on, an encode gives the
tree ``encode`` > ``batch`` > the stages, every span under one encode id;
the batch layer counts its host syncs and its batches sent to the staged
encoder; spans share ``torch.profiler``'s clock; each in-flight thread
keeps its own parent stack.  Inputs are at most 32 KiB, 8 KiB segments.
"""

import os

import pytest

torch = pytest.importorskip("torch")

from orz_tpu_torch import trace  # noqa: E402
from orz_tpu_torch.device import batch as tb  # noqa: E402
from orz_tpu_torch.device import container  # noqa: E402

SEG = 8192
L1_STAGES = ["FRONT", "MID", "BACK"]
L2_STAGES = ["FRONT", "QUALITY scan", "QUALITY tail", "MID2", "BACK"]
# the host syncs of an l1 batch, in order (sync.extend_nonzero once a FRONT)
L1_SYNCS = ["h2d_bufs", "h2d_lens", "extend_nonzero", "m_cap", "skewed",
            "fetch_meta", "fetch_words"]


def text(n: int, seed: int = 0) -> bytes:
    """`n` bytes of this repository's README, from offset `seed`."""
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "README.md"), "rb") as f:
        src = f.read()
    return (src[seed:] + src)[:n]


@pytest.fixture
def traced():
    """Spans on for the test, off after it whatever happens."""
    trace.start()
    try:
        yield
    finally:
        trace.stop()


def encode(data: bytes, level: int = 1, batch: int = 2) -> bytes:
    return container.torch_encode_bytes(data, level=level, device="cpu",
                                        segment_size=SEG, batch=batch)


def children(recs, parent):
    return [r for r in sorted(recs, key=lambda r: r["start"])
            if r["parent"] == parent["id"]]


def only(recs, name):
    got = [r for r in recs if r["name"] == name]
    assert len(got) == 1, (name, [r["name"] for r in recs])
    return got[0]


def test_off_records_nothing():
    assert trace.span("encode") is trace.OFF
    assert trace.sync("x") is trace.OFF and trace.current() is None
    assert trace.under(object()) is trace.OFF
    encode(text(2 * SEG))
    assert trace.stop() == []


@pytest.mark.parametrize("level", [1, 2])
def test_span_tree(monkeypatch, level):
    """encode > read, batch, frame; batch > pad_h2d, the level's stages,
    the batch's syncs and one assemble a segment; one encode id; the
    batch's number on each of its spans; each span inside its parent."""
    monkeypatch.setenv("OTZ2_SCHEDULE", "96x1,384x2")
    data = text(2 * SEG)
    trace.start()
    try:
        out = encode(data, level)
    finally:
        recs = trace.stop()
    assert container.torch_decode_bytes(out) == data
    enc = only(recs, "encode")
    assert enc["parent"] is None and enc["level"] == level
    assert {r["encode"] for r in recs} == {enc["id"]}
    b = only(recs, "batch")
    assert b["parent"] == enc["id"] and b["segments"] == 2
    kids = [r["name"] for r in children(recs, enc)]
    assert kids == ["read", "batch", "frame", "frame", "read"]
    kids = [r["name"] for r in children(recs, b)]
    stages = L1_STAGES if level == 1 else L2_STAGES
    assert [k for k in kids if not k.startswith("sync.")] == \
        ["pad_h2d"] + stages + ["assemble", "assemble"]
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["parent"] is not None:
            up = by_id[r["parent"]]
            assert up["start"] <= r["start"] <= r["end"] <= up["end"]
        assert r["batch"] == (None if r["name"] in ("encode", "read", "frame")
                              else b["batch"])


def test_host_syncs_and_staged_batches():
    """One l1 batch passes the known sync sites, each a ``sync.*`` span;
    a batch holding an empty segment goes to the staged encoder once."""
    trace.host_syncs, tb.staged_batches = 0, 0
    trace.start()
    try:
        tb.encode_segments_batch([text(SEG), text(SEG, 99)], 1, device="cpu")
    finally:
        recs = trace.stop()
    syncs = [r["name"][5:] for r in sorted(recs, key=lambda r: r["start"])
             if r["name"].startswith("sync.")]
    assert syncs == L1_SYNCS and trace.host_syncs == len(L1_SYNCS)
    assert tb.staged_batches == 0
    tb.encode_segments_batch([b"", text(SEG)], 1, device="cpu")
    assert tb.staged_batches == 1


def test_spans_share_the_profilers_clock():
    """Under torch.profiler (CPU activity), every ``aten::`` op that runs
    inside FRONT's ``record_function`` (opened by a ``stage`` hook, inside
    the span) lies within FRONT's span: the two clocks are one."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def stage(name, fn):
        with record_function("stage " + name):
            return fn()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.start()
        try:
            tb.encode_segments_batch([text(SEG)], 1, device="cpu",
                                     stage=stage)
        finally:
            recs = trace.stop()
    front = only(recs, "FRONT")
    events = prof.profiler.kineto_results.events()

    def ns(e):
        return e.start_ns(), e.start_ns() + e.duration_ns()

    (rf_lo, rf_hi), = [ns(e) for e in events if e.name() == "stage FRONT"]
    assert front["start"] <= rf_lo <= rf_hi <= front["end"]
    inside = [ns(e) for e in events if e.name().startswith("aten::")
              and rf_lo <= ns(e)[0] <= rf_hi]
    assert len(inside) > 10
    assert all(front["start"] <= s <= t <= front["end"] for s, t in inside)


def test_inflight_threads_keep_their_own_stacks(monkeypatch, traced):
    """At ORZ_INFLIGHT=2 each batch runs on a pool thread: its spans nest
    under its own batch span on that thread, and the batch under the
    caller's encode span."""
    monkeypatch.setenv("ORZ_INFLIGHT", "2")
    data = text(4 * SEG, 7)
    out = encode(data, batch=1)
    recs = trace.stop()
    assert container.torch_decode_bytes(out) == data
    enc = only(recs, "encode")
    batches = [r for r in recs if r["name"] == "batch"]
    assert len(batches) == 4
    assert {b["parent"] for b in batches} == {enc["id"]}
    assert len({b["batch"] for b in batches}) == 4
    assert all(b["thread"] != enc["thread"] for b in batches)
    for b in batches:
        kids = children(recs, b)
        assert {k["thread"] for k in kids} == {b["thread"]}
        assert [k["name"] for k in kids if k["name"] in L1_STAGES] == L1_STAGES
        assert all(k["batch"] == b["batch"] for k in kids)
