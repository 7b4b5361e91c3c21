"""The container's and the batch layer's slot counters, on the CPU with
stub encoders (no device stage runs, each test well under a second).

``device/pcontainer.py`` ``encoded_segments`` counts the slots of each
batch call (``batch_slots``: one a segment, since an EOF leftover batch is
encoded at its own size), the padding copies among them (``pad_slots``:
none) and the calls with fewer than ``batch`` segments
(``short_batches``); ``device/batch.py`` counts the segments of the
batches it sends whole to the staged encoder (``staged_segments``) beside
the batches (``staged_batches``).  All values are integers: tolerance 0.
"""

import io

import pytest

torch = pytest.importorskip("torch")

from orz_tpu_torch.device import batch as tb  # noqa: E402
from orz_tpu_torch.device import pcontainer as tpc  # noqa: E402

SEG = 100
BATCH = 4


def segments(n: int) -> list[bytes]:
    """`n` distinct segments of SEG bytes, the last one short."""
    segs = [bytes([i]) * SEG for i in range(n)]
    if segs:
        segs[-1] = segs[-1][:SEG // 2]
    return segs


# segments in the input: (batch slots, padding slots), the segments of each
# batch call, and the calls with fewer than 4, worked out by hand at 4 a
# batch
SLOTS = {0: (0, 0), 1: (1, 0), 4: (4, 0), 5: (5, 0), 7: (7, 0)}
CALLS = {0: [], 1: [1], 4: [4], 5: [4, 1], 7: [4, 3]}
SHORT = {0: 0, 1: 1, 4: 0, 5: 1, 7: 1}


@pytest.mark.parametrize("inflight", ["1", "2"])
@pytest.mark.parametrize("n", sorted(SLOTS))
def test_batch_and_pad_slots(monkeypatch, n, inflight):
    """Each batch call adds one slot a segment and no padding copy; the
    file's last batch is called with the segments left, and slot k's
    payload is segment k's, in file order."""
    monkeypatch.setenv("ORZ_INFLIGHT", inflight)
    monkeypatch.setattr(tpc, "batch_slots", 0)
    monkeypatch.setattr(tpc, "pad_slots", 0)
    monkeypatch.setattr(tpc, "short_batches", 0)
    calls = []

    def encode_batch(segs):
        calls.append(len(segs))
        # slot k's payload names its slot: a payload in the wrong slot
        # or the wrong order differs from the one wanted
        return [s + b"|%d" % k for k, s in enumerate(segs)]

    segs = segments(n)
    out = list(tpc.encoded_segments(io.BytesIO(b"".join(segs)), encode_batch,
                                    lambda s: s, SEG, BATCH))
    want = [(len(s), s + b"|%d" % (i % BATCH)) for i, s in enumerate(segs)]
    assert out == want
    assert calls == CALLS[n]
    assert (tpc.batch_slots, tpc.pad_slots) == SLOTS[n]
    assert tpc.short_batches == SHORT[n]


def test_staged_segments_counts_an_empty_segments_batch(monkeypatch):
    """A batch that holds an empty segment goes whole to the staged
    encoder: one batch, and each of its three segments."""
    from orz_tpu_torch.device import pipeline

    monkeypatch.setattr(tb, "staged_batches", 0)
    monkeypatch.setattr(tb, "staged_segments", 0)
    monkeypatch.setattr(pipeline, "encode_segment_staged",
                        lambda d, *a, **kw: b"staged" + d)
    datas = [b"", b"abc", b"defg"]
    assert tb.encode_segments_batch(datas, 2, device="cpu") == [
        b"staged" + d for d in datas]
    assert (tb.staged_batches, tb.staged_segments) == (1, 3)
    tb.encode_segments_batch([b"x", b""], 1, device="cpu")
    assert (tb.staged_batches, tb.staged_segments) == (2, 5)
