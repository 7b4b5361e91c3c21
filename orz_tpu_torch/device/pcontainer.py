"""ORZT container framing, the device encoder's branch of
``orz_tpu/pcontainer.py`` ``pipe_encode`` (TPU_MAGIC), copied for the port.

The wire format, the byte counters, the length varints and the decode loop
are the host container's (``orz_tpu_torch/pcontainer.py``,
``orz_tpu_torch/ioutil.py``).  ``pipe_encode`` here is the original's
batched branch: segments are read ``batch`` at a time and encoded by one
``encode_batch`` call, with up to ``ORZ_INFLIGHT`` batches in flight (read
at each call; default 1, as in the original).  An EOF leftover batch is
encoded at its own segment count.  The original pads it with copies of
its first segment and drops their payloads, so that XLA reuses the
program compiled for the full batch's shapes; the port's ops and kernels
take the batch size at run time, and a segment's payload does not depend
on its batch-mates, so the port needs no copies and writes the same
bytes.  A batch call that raises is retried segment by segment through
``encode_one``, in the caller's thread.  ``encoded_segments`` is that
loop; ``orz_tpu_torch/checkpoint.py`` encodes per segment instead
(``pcontainer.pooled_segments``), as the original's
``checkpointed_encode`` does.  ``tests/test_torch_host.py`` and
``tests/test_torch_inflight.py`` hold the bytes to the original's.
"""

from __future__ import annotations

import itertools
import os
from concurrent.futures import Future, ThreadPoolExecutor

from orz_tpu_torch import trace
from orz_tpu_torch.pcontainer import frame_segments, read_segment
from orz_tpu_torch.progress import ProgressLogger


# Since the last reset: the slots (segments) of the batch calls made, the
# padding copies among them (none since a short batch runs at its own
# size: the benchmark's pad_share reads 0), and the calls made with fewer
# than `batch` segments.
batch_slots = 0
pad_slots = 0
short_batches = 0


class _Serial:
    """An executor that runs each call when it is submitted, on the
    caller's thread (one batch in flight: no thread, the caller's
    stream)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args) -> Future:
        fut = Future()
        try:
            fut.set_result(fn(*args))
        except Exception as e:  # raised again by fut.result()
            fut.set_exception(e)
        return fut


def encoded_segments(source, encode_batch, encode_one, segment_size: int,
                     batch: int, slot_init=None):
    """Yield (segment length, payload) in file order: `segment_size`
    segments read `batch` at a time and encoded by one encode_batch call,
    with up to ``ORZ_INFLIGHT`` calls in flight on as many threads, reading
    ahead until that many are pending.  Each thread of that pool first
    calls ``slot_init(slot)``, its slot numbered from 0, where the caller
    can bind per-slot state (a device stream) to it."""
    bsz = max(batch, 1)
    inflight = max(1, int(os.environ.get("ORZ_INFLIGHT", "1")))

    def run(segs, parent):  # parent: the caller's span, for a pool thread
        trace.count(globals(), "batch_slots", len(segs))
        if len(segs) < bsz:
            trace.count(globals(), "short_batches")
        with trace.under(parent):
            return encode_batch(segs)

    if inflight == 1:
        pool = _Serial()
    else:
        slots = itertools.count()
        pool = ThreadPoolExecutor(
            max_workers=inflight,
            initializer=None if slot_init is None else (
                lambda: slot_init(next(slots))))
    with pool:
        pending = []  # (segments, future of their payloads), file order
        eof = False
        while not eof or pending:
            while not eof and len(pending) < inflight:
                segs = []
                with trace.span("read"):
                    while len(segs) < bsz:
                        seg = read_segment(source, segment_size)
                        if not seg:
                            eof = True
                            break
                        segs.append(seg)
                if not segs:
                    break
                pending.append((segs, pool.submit(run, segs, trace.current())))
            if pending:
                segs, fut = pending.pop(0)
                try:
                    payloads = fut.result()
                except Exception:
                    # recovery at segment granularity: a failed batch call
                    # (device out of memory, a transient error) re-encodes
                    # its segments one at a time; a second failure
                    # propagates
                    payloads = [encode_one(s) for s in segs]
                yield from zip((len(s) for s in segs), payloads)


def pipe_encode(source, target, encode_batch, encode_one, magic: bytes,
                segment_size: int, batch: int,
                progress: ProgressLogger | None = None,
                slot_init=None) -> None:
    """Read `segment_size` segments, encode `batch` per encode_batch call
    (``ORZ_INFLIGHT`` calls in flight), and frame the payloads in file
    order."""
    frame_segments(source, target, magic, segment_size,
                   lambda src: encoded_segments(src, encode_batch, encode_one,
                                                segment_size, batch,
                                                slot_init),
                   progress)
