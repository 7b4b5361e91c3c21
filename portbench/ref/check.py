"""The output check: what the window's encodes produced, against the plain
reference decoder ``otz.py``.

For every input of the window: the ORZT framing parses, it holds one
segment per ``segment_size`` bytes of the input, and each segment's header
states that segment's length.  Every segment's first ``prefix_bytes``
decode to the input's bytes.  One segment at each position of each input
size decodes whole to the input's bytes: a file's every segment position
(so every batch and every slot of a batch), an object mix's every object,
each drawn from the seed among the window's inputs.  (A segment's later
chunks cannot be checked apart: the symbol-rank state and the bit offset
of a chunk follow from every item before it.)  Two numbers come out, each
held to its limit:

- ``streams_bad``: inputs whose framing or a segment header is wrong, or
  a segment of which the decoder refuses;
- ``bytes_wrong``: decoded bytes that differ from the input, with bytes
  missing or in excess, over everything decoded.

The decodes run in child processes (plain Python; no torch).
"""

from __future__ import annotations

import os
import pickle
import random
import subprocess
import sys

import otz

LIMITS = {"bytes_wrong": 0, "streams_bad": 0}


def diff(a: bytes, b: bytes) -> int:
    """Positions at which a and b differ, counting a length difference."""
    if a == b:
        return 0
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def prefix_payload(payload: bytes, prefix: int) -> bytes:
    """Enough of a payload to decode its first `prefix` bytes: an item
    codes at least one byte in at most 44 bits (a 15-bit code, 14 offset
    bits, a 15-bit length code), and a chunk's three tables take under
    4 KiB; the cut leaves room for sixteen chunks."""
    return payload[:6 * prefix + 65536]


def job(args):
    """Decode one segment (to `limit` bytes, or whole) and compare:
    (bytes wrong, refused)."""
    payload, expect, limit = args
    try:
        out = otz.decode_segment(payload, limit)
    except Exception:
        return len(expect), True
    if limit is not None:
        want = expect[:max(len(out), min(limit, len(expect)))]
        return diff(out[:len(want)], want), False
    return diff(out, expect), False


def run_jobs(jobs: list, workers: int) -> list:
    """job() of each of `jobs`, on `workers` child processes (each started
    as ``python check.py``, fed its share through a pipe; nothing shared
    on disk or in memory) or, at 1, in this process."""
    if workers <= 1 or len(jobs) <= 1:
        return [job(j) for j in jobs]
    # the whole decodes first, spread over the workers, then the prefixes
    order = sorted(range(len(jobs)), key=lambda j: jobs[j][2] is not None)
    shares = [order[w::workers] for w in range(workers)]
    procs = []
    for share in shares:
        p = subprocess.Popen([sys.executable, os.path.abspath(__file__)],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        procs.append((p, share))
    out = [None] * len(jobs)
    try:
        for p, share in procs:
            p.stdin.write(pickle.dumps([jobs[j] for j in share]))
            p.stdin.close()
        for p, share in procs:
            for j, r in zip(share, pickle.loads(p.stdout.read())):
                out[j] = r
    except BaseException:
        for p, _ in procs:
            p.kill()
        raise
    finally:
        for p, _ in procs:
            p.stdout.close()
            p.wait()
    return out


def check(src, outs: list[bytes], sizes: list[int], seed: int, params: dict,
          segment: int, workers: int | None = None) -> dict:
    """(the numbers compared, the inputs found wrong) for the window's
    outputs `outs` (input i of the window is ``src.item(i)``, ``sizes[i]``
    bytes long)."""
    bad = set()
    segs = []  # (input, segment index, its length, payload)
    for i, (stream, data_len) in enumerate(zip(outs, sizes)):
        try:
            seg, payloads = otz.read_container(stream)
            want = -(-data_len // seg) if data_len else 0
            if seg != segment or len(payloads) != want:
                raise otz.FormatError("segment count")
            for k, pl in enumerate(payloads):
                ln = min(seg, data_len - k * seg)
                if otz.segment_header(pl)[0] != ln:
                    raise otz.FormatError("segment length")
                segs.append((i, k, ln, pl))
        except (otz.FormatError, ValueError):
            bad.add(i)
    # one whole segment at each (input size, segment index), from the seed
    r = random.Random(seed * 2654435761 + 12345)
    groups = {}
    for j, (i, k, ln, pl) in enumerate(segs):
        groups.setdefault((sizes[i], k), []).append(j)
    full = {r.choice(groups[g]) for g in sorted(groups)}
    jobs, owner = [], []
    cache = {}
    pre = params["prefix_bytes"]
    for j, (i, k, ln, pl) in enumerate(segs):
        if i not in cache:
            cache.clear()
            cache[i] = src.item(i)
        data = cache[i][k * segment:k * segment + ln]
        if j in full:
            jobs.append((pl, data, None))
        else:
            jobs.append((prefix_payload(pl, pre), data[:pre + 512], pre))
        owner.append(i)
    cache.clear()
    if workers is None:
        workers = max(1, min(6, (os.cpu_count() or 2) - 1))
    results = run_jobs(jobs, workers)
    wrong, failed = 0, set(bad)
    for j, (w, refused) in enumerate(results):
        wrong += w
        if refused:
            bad.add(owner[j])
        if w or refused:
            failed.add(owner[j])
    return {"bytes_wrong": wrong, "streams_bad": len(bad)}, len(failed)


if __name__ == "__main__":  # a worker of run_jobs: jobs on stdin, results on stdout
    sys.stdout.buffer.write(pickle.dumps([job(j) for j in pickle.loads(sys.stdin.buffer.read())]))
