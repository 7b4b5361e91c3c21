"""The output check's control and the faults it must catch.

Each entry breaks the timed path underneath the harness, through the
batch layer's entry ``encode_segments_batch`` that the container calls:

- ``control``: a lossy encoder, the broken guarantee: one byte of every
  segment is changed before it is encoded, so the stream is valid and
  decodes to other bytes;
- ``unchanged``: the step returns its state unchanged (each segment's
  payload is its own input bytes);
- ``half_batch``: half of the batch left out (the first half is encoded
  and its payloads stand for the rest too);
- ``token``: an answer altered where it is produced (one byte of every
  payload, past its header, is changed).

On a card, at a cell's own size:

    python3 portbench/tests/faults.py --workload l2-enwik8 --fault control \\
        --seeds 11,12,13 --seconds 5

prints, for each seed, the check's numbers of a run with the fault.
"""

from __future__ import annotations

import hashlib


def _spot(data: bytes, lo: int = 0) -> int:
    """A position in [lo, len(data)) drawn from the bytes themselves."""
    h = int.from_bytes(hashlib.sha256(data[:4096]).digest()[:8], "little")
    return lo + h % max(1, len(data) - lo)


def _flip(data: bytes, at: int) -> bytes:
    return data[:at] + bytes([data[at] ^ 0x5A]) + data[at + 1:]


def control(orig):
    def encode_segments_batch(datas, *a, **kw):
        return orig([_flip(d, _spot(d)) for d in datas], *a, **kw)
    return encode_segments_batch


def unchanged(orig):
    def encode_segments_batch(datas, *a, **kw):
        return [bytes(d) for d in datas]
    return encode_segments_batch


def half_batch(orig):
    def encode_segments_batch(datas, *a, **kw):
        h = max(1, len(datas) // 2)
        out = orig(datas[:h], *a, **kw)
        return [out[i % h] for i in range(len(datas))]
    return encode_segments_batch


def token(orig):
    def encode_segments_batch(datas, *a, **kw):
        return [_flip(p, _spot(p, min(16, len(p) - 1)))
                for p in orig(datas, *a, **kw)]
    return encode_segments_batch


FAULTS = {"control": control, "unchanged": unchanged,
          "half_batch": half_batch, "token": token}


def patch(name: str):
    """The harness's `patch` argument for fault `name`."""
    def apply(container):
        orig = getattr(apply, "orig", None) or container.encode_segments_batch
        apply.orig = orig
        container.encode_segments_batch = FAULTS[name](orig)
    return apply


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import sys
    import time

    t_start = time.perf_counter()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.dirname(here))
    sys.path.insert(0, here)
    import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS) + ["none"], required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    a = ap.parse_args(argv)
    fault = None if a.fault == "none" else patch(a.fault)
    for seed in (int(s) for s in a.seeds.split(",")):
        res = harness.run_cell(a.workload, seed, a.seconds, False, t_start,
                               patch=fault)
        print(json.dumps({"workload": a.workload, "fault": a.fault, "seed": seed,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "check": res["check"]}), flush=True)
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
