"""Batches in flight (``ORZ_INFLIGHT``) in the port's ORZT encode loop.

``orz_tpu_torch/device/pcontainer.py`` ``encoded_segments`` against the
JAX package's ``orz_tpu/pcontainer.py`` ``pipe_encode`` (batched branch)
with the same fake encoders: framing bytes, the sequence of progress
calls, concurrency, the failed-batch retry and the knob's parsing; then
the port's real encoder on the CPU at several ``ORZ_INFLIGHT`` values, and
the thread-safe counters.  ``orz_tpu.pcontainer`` imports neither jax nor
torch, so no JAX program is compiled here.  All outputs are bytes or
integers: tolerance 0.
"""

import io
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from orz_tpu import pcontainer as jpc
from orz_tpu_torch import pcontainer as hpc
from orz_tpu_torch.device import pcontainer as tpc


class Recorder:
    """A progress logger that records its calls."""

    def __init__(self):
        self.calls = []

    def set_is_encode(self, is_encode):
        self.calls.append(("set_is_encode", is_encode))

    def log(self, num_in, num_out):
        self.calls.append(("log", num_in, num_out))

    def finish(self, num_in, num_out):
        self.calls.append(("finish", num_in, num_out))


def fake_encode(seg: bytes) -> bytes:  # any bytes -> bytes frames the same
    return seg[::-1] + bytes([len(seg) % 251])


def fake_batch(segs):
    return [fake_encode(s) for s in segs]


def ours(data, seg_size, bsz, encode_batch=fake_batch, encode_one=fake_encode):
    out, progress = io.BytesIO(), Recorder()
    tpc.pipe_encode(io.BytesIO(data), out, encode_batch, encode_one,
                    hpc.TPU_MAGIC, seg_size, bsz, progress)
    return out.getvalue(), progress.calls


def theirs(data, seg_size, bsz, encode_batch=fake_batch,
           encode_one=fake_encode):
    out, progress = io.BytesIO(), Recorder()
    jpc.pipe_encode(io.BytesIO(data), out, encode_one, jpc.TPU_MAGIC,
                    seg_size, bsz, progress, encode_batch=encode_batch,
                    batch_size=bsz)
    return out.getvalue(), progress.calls


def _bytes(n: int, seed: int = 0x1F1) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


# (input bytes, segment size, batch): EOF leftovers of 1 and 2 segments,
# exact multiples of the batch, a short last segment, one segment, none
FRAMING_CASES = [(10_000, 1000, 3), (10_000, 1000, 4), (10_000, 2500, 2),
                 (12_000, 1000, 4), (7000, 3000, 1), (500, 1000, 2),
                 (0, 1000, 2)]


@pytest.mark.parametrize("inflight", ["0", "1", "2", "3"])
@pytest.mark.parametrize("n,seg_size,bsz", FRAMING_CASES)
def test_framing_and_progress_match_jax(monkeypatch, inflight, n, seg_size,
                                        bsz):
    monkeypatch.setenv("ORZ_INFLIGHT", inflight)
    data = _bytes(n)
    got = ours(data, seg_size, bsz)
    assert got == theirs(data, seg_size, bsz)
    back = io.BytesIO()
    hpc.pipe_decode(io.BytesIO(got[0]), back, lambda p: p[:-1][::-1],
                    hpc.TPU_MAGIC, 2)
    assert back.getvalue() == data


@pytest.mark.parametrize("run", [ours, theirs], ids=["port", "jax"])
def test_two_batches_are_in_flight_at_once(monkeypatch, run):
    """At ORZ_INFLIGHT=2 each batch call waits at a two-party barrier, which
    only two calls running at once get past; a call that could not would
    break the barrier and go through the per-segment retry."""
    monkeypatch.setenv("ORZ_INFLIGHT", "2")
    barrier = threading.Barrier(2, timeout=10)
    retried = []

    def encode_batch(segs):
        barrier.wait()
        return fake_batch(segs)

    def encode_one(seg):
        retried.append(seg)
        return fake_encode(seg)

    data = _bytes(8000)  # four batches of two 1000-byte segments
    got, calls = run(data, 1000, 2, encode_batch, encode_one)
    assert retried == []
    assert got == theirs(data, 1000, 2)[0]
    assert len(calls) == 10


@pytest.mark.parametrize("inflight", ["1", "2", "3"])
def test_failed_batch_is_retried_in_file_order(monkeypatch, inflight):
    """A failed middle batch is re-encoded one segment at a time, in file
    order, in both packages; a second failure raises in both."""
    monkeypatch.setenv("ORZ_INFLIGHT", inflight)
    data = _bytes(9000)  # segments of 1000 bytes, batches of 3
    middle = data[3000:4000]

    def encode_batch(segs):
        if segs[0] == middle:
            raise RuntimeError("device out of memory")
        return fake_batch(segs)

    def retried_by(run):
        calls = []

        def encode_one(seg):
            calls.append(data.index(seg))
            return fake_encode(seg)

        return run(data, 1000, 3, encode_batch, encode_one), calls

    got = retried_by(ours)
    assert got == retried_by(theirs)
    assert got[1] == [3000, 4000, 5000]
    assert got[0][0] == ours(data, 1000, 3)[0]

    def fails_again(seg):
        raise ValueError("second failure")

    for run in (ours, theirs):
        with pytest.raises(ValueError, match="second failure"):
            run(data, 1000, 3, encode_batch, fails_again)


@pytest.mark.parametrize("run", [ours, theirs], ids=["port", "jax"])
def test_inflight_not_an_integer_raises(monkeypatch, run):
    monkeypatch.setenv("ORZ_INFLIGHT", "x")
    with pytest.raises(ValueError):
        run(_bytes(3000), 1000, 2)


def _text(n: int, seed: int) -> bytes:
    """Zipf-distributed words: matches, words and literals all occur."""
    rng = np.random.default_rng(seed)
    vocab = [rng.integers(97, 123, int(rng.integers(2, 9)),
                          dtype=np.uint8).tobytes() for _ in range(300)]
    words = [vocab[i % 300] for i in rng.zipf(1.3, n // 3)]
    return b" ".join(words)[:n]


def test_real_encoder_l1_equal_at_each_inflight(monkeypatch):
    """96 KiB at l1 in 16 KiB segments, two a batch: three batches."""
    from orz_tpu_torch.device import container

    data = _text(96 << 10, 0x1F2)
    streams = {}
    for inflight in ("1", "2", "3"):
        monkeypatch.setenv("ORZ_INFLIGHT", inflight)
        container.segment_retries = 0
        streams[inflight] = container.torch_encode_bytes(
            data, level=1, segment_size=1 << 14, batch=2, device="cpu")
        assert container.segment_retries == 0
    assert streams["2"] == streams["1"]
    assert streams["3"] == streams["1"]
    assert container.torch_decode_bytes(streams["2"]) == data


def test_real_encoder_l2_equal_at_each_inflight(monkeypatch):
    """48 KiB at l2 (the short schedule) in 16 KiB segments, one a batch."""
    from orz_tpu_torch.device import container

    monkeypatch.setenv("OTZ2_SCHEDULE", "96x1,384x2")
    data = _text(48 << 10, 0x1F3)
    streams = {}
    for inflight in ("1", "2"):
        monkeypatch.setenv("ORZ_INFLIGHT", inflight)
        streams[inflight] = container.torch_encode_bytes(
            data, level=2, segment_size=1 << 14, batch=1, device="cpu")
    assert streams["2"] == streams["1"]
    assert container.torch_decode_bytes(streams["2"]) == data


# segments of 4096 bytes in the input, the last one short: a lone short
# segment; a full batch and a leftover of 1; a full batch and a leftover
# of 3
SHORT_BATCH_SEGMENTS = [1, 5, 7]


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("n_segs", SHORT_BATCH_SEGMENTS)
def test_short_batch_equals_the_padded_loop(monkeypatch, level, n_segs):
    """The real encoder at batch 4: the port's loop, which encodes a file's
    last batch at its own segment count, writes the bytes of the JAX
    package's loop, which pads that batch to 4 with copies of its first
    segment and drops their payloads; both decode to the input."""
    from orz_tpu_torch.device import container

    monkeypatch.setenv("OTZ2_SCHEDULE", "96x1,384x2")
    monkeypatch.delenv("ORZ_INFLIGHT", raising=False)
    seg = 4096
    data = _text(n_segs * seg - 1000, 0x1F4 + n_segs)
    encode_batch, _ = container.segment_encoders(level, segment_size=seg,
                                                 device="cpu")
    calls = []

    def recorded(segs):
        calls.append(len(segs))
        return encode_batch(segs)

    def no_retry(seg):
        raise AssertionError("a batch call failed and was retried")

    got = ours(data, seg, 4, recorded, no_retry)[0]
    port_calls = calls[:]
    calls.clear()
    want = theirs(data, seg, 4, recorded, no_retry)[0]
    assert port_calls == [4] * (n_segs // 4) + [n_segs % 4]
    assert calls == [4] * len(port_calls)
    assert got == want
    assert container.torch_decode_bytes(got) == data


def test_counter_is_exact_under_threads():
    """Eight threads add to one counter through the locked helper.  The
    counter's namespace gives up the interpreter lock between the read and
    the write of each addition, so without the helper's lock the threads
    would lose updates and leave the total short."""
    import time

    from orz_tpu_torch import trace

    class Namespace(dict):
        def __setitem__(self, key, value):
            time.sleep(0)  # another thread runs between read and write
            super().__setitem__(key, value)

    counters = Namespace(launches=0)
    per_thread = 2000

    def hammer():
        for _ in range(per_thread):
            trace.count(counters)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert counters["launches"] == 8 * per_thread
