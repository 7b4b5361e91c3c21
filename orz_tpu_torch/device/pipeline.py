"""The per-segment staged encoder: ``orz_tpu/device/pipeline.py`` in torch.

One segment at a time, in stages with a host sync between them, as JAX
runs its per-segment programs:

- FRONT (``dispatch_segment_front``): the unmasked analysis, the parse and
  the fence walk of the segment, padded to its own length bucket.
- MID (``dispatch_segment_mid``, OTZ1): one sync of n_items for the item
  bucket, then the item fields and the symrank plan stats.
- MID2 (``dispatch_segment_mid2``, OTZ2): the masked re-parse schedule,
  then the best-of-N emission (``best_emission``): the newest iterate is
  conformed, repaired and emitted first, and older ones only while the last
  candidate failed or demoted more than ``thr`` items; of those that
  repaired, the one with the fewest demotions wins.  If none did, the OTZ1
  MID runs from the FRONT outputs.
- BACK (``dispatch_segment_back``): one sync of the plan stats, the skew
  check (rounds past the first C_MID contexts above ``R_CAP_MAX`` send the
  segment to ``encode_segment_device``), then census, symrank, entropy and
  packing; ``finish_segment`` fetches and assembles the payload.

The bodies are the batched chain's (``device/batch.py``, ``ops/``) at
B=1, so K1-K5 run here as there.  ``encode_segment_device`` is JAX's
monolithic OTZ1 program: here the OTZ1 chain at B=1 with no skew check.
Every entry point runs on ``device`` ("cuda" unless the caller asks for
the CPU) and raises without CUDA.  Payloads are byte-identical to JAX's
(``tests/test_torch_pipeline.py``).
"""

from __future__ import annotations

import torch

from orz_tpu_torch import trace
from orz_tpu_torch.bitio import BitEncoder
from orz_tpu_torch.device import host
from orz_tpu_torch.device.batch import (
    assemble,
    emit_iterate,
    fetch_out,
    m2_cap_for,
    resolve_device,
)
from orz_tpu_torch.device.host import _bucket, _bucket_capacity, pad_batch
from orz_tpu_torch.ops.batched import (
    back_body_b,
    front_body_b,
    masked_plan_b,
    mid_body_b,
    plan_stats_b,
)
from orz_tpu_torch.ops.otz2 import (
    conform_mask_b,
    iter2_full_step_b,
    iter2_mask_step_b,
)
from orz_tpu_torch.spec import (
    CHUNK_INPUT_DEFAULT,
    OTZ2_CONFORM_SHIFTS,
    candidate_depth,
    n_chunks_for,
    otz2_enabled,
    otz2_schedule,
)


def empty_payload(chunk_input: int) -> bytes:
    """The payload of an empty segment: its header alone."""
    enc = BitEncoder()
    enc.encode_varint(0)
    enc.encode_varint(chunk_input)
    return enc.finish()


def segment_state(data: bytes, level: int, chunk_input: int, c_max: int,
                  seg_lens, front) -> dict:
    """The staged state of one segment after FRONT: ``front`` = (starts,
    n_items, pk1, bestq, bestro, bufs, mask), each of batch 1."""
    return {"empty": False, "data": data, "level": level,
            "chunk_input": chunk_input, "c_max": c_max, "seg_lens": seg_lens,
            "front": front}


def dispatch_segment_front(data: bytes, level: int, chunk_input: int,
                           device: str | torch.device = "cuda") -> dict:
    """FRONT of one segment, padded to its own length bucket; returns the
    staged state."""
    if not data:
        return {"empty": True, "data": data, "chunk_input": chunk_input}
    device = resolve_device(device, "dispatch_segment_front")
    cap = _bucket_capacity(len(data))
    bufs_np, lens_np = pad_batch([data], cap)
    with trace.sync("h2d_bufs"):
        bufs = torch.from_numpy(bufs_np).to(device)
    with trace.sync("h2d_lens"):
        seg_lens = torch.from_numpy(lens_np).to(device)
    return segment_state(data, level, chunk_input,
                         n_chunks_for(cap, chunk_input), seg_lens,
                         front_body_b(bufs, seg_lens, candidate_depth(level)))


def dispatch_segment_mid(front: dict) -> dict:
    """OTZ1 MID: sync n_items, build the items at their bucket."""
    if front["empty"]:
        return front
    starts, n_items, pk1, bestq, bestro, bufs, _ = front["front"]
    with trace.sync("m_cap"):
        m_cap = _bucket(max(int(n_items), 1), 1 << 14, 2)
    items, r1, rounds = mid_body_b(starts, n_items, pk1, bestq, bestro, bufs,
                                   front["seg_lens"], m_cap)
    return dict(front, items=items, r1=r1, rounds=rounds)


def best_emission(emit, iterates, thr: int):
    """JAX's best-of-N emission pick over ``iterates``, newest first.
    ``emit(it)`` returns (ok, demotions, out).  The newest is always
    emitted; each older one only while the last emitted failed or demoted
    more than `thr`.  Returns (the chosen emission or None, every emission
    in order): the one with the fewest demotions among those that are ok,
    the first emitted on a tie; None if none is ok."""
    cand = [emit(iterates[0])]
    for it in iterates[1:]:
        ok, dem = cand[-1][:2]
        if ok and dem <= thr:
            break
        cand.append(emit(it))
    good = [c for c in cand if c[0]]
    return (min(good, key=lambda c: c[1]) if good else None), cand


def dispatch_segment_mid2(front: dict) -> dict:
    """OTZ2 MID: the schedule's head as mask-carry steps (its last step a
    full one, so that its iterate is kept), the last min(3, len(schedule))
    steps one at a time, keeping the iterates they start from (up to
    three), then ``best_emission`` over the newest iterate and those, with
    thr = max(1024, n_items >> 7) of the newest.  Each emission conforms
    the iterate at OTZ2_CONFORM_SHIFTS (or the schedule's last depth) and
    repairs it at its own item bucket.  Falls back to the OTZ1 MID, with
    rings_mode 0, when no emission repaired.  The state records each
    emission's (ok, demotions) as "emissions" and thr as "thr"."""
    if front["empty"]:
        return front
    starts, n_items, pk1, _, _, bufs, mask0 = front["front"]
    seg_lens = front["seg_lens"]
    plan = masked_plan_b(bufs, seg_lens)
    schedule = otz2_schedule(front["level"])
    n_tail = min(3, len(schedule))
    head, tail = schedule[:len(schedule) - n_tail], schedule[-n_tail:]
    it = (starts, n_items, pk1, mask0)  # (starts, n_items, pk1, mask)
    mask = mask0
    for depth in head[:-1]:
        mask, _ = iter2_mask_step_b(bufs, seg_lens, depth, mask, plan)
    if head:
        it = iter2_full_step_b(bufs, seg_lens, head[-1], mask, plan)
    del mask
    hist = []  # iterates the tail steps start from, newest last
    for depth in tail:
        hist = hist[-2:] + [it]
        it = iter2_full_step_b(bufs, seg_lens, depth, it[3], plan)
    c_shifts = OTZ2_CONFORM_SHIFTS or schedule[-1]

    def emit(it):
        st, ni, pk, mask = it
        bq2, bl2 = conform_mask_b(bufs, seg_lens, c_shifts, mask, plan)
        with trace.sync("m2_cap"):
            m2_cap = m2_cap_for(int(ni))
        items, ok, dem = emit_iterate(bufs, seg_lens, (st, ni, pk, bq2, bl2),
                                      m2_cap)
        with trace.sync("emission_ok"):
            ok = bool(ok)
        with trace.sync("emission_dem"):
            dem = int(dem)
        return ok, dem, items

    with trace.sync("thr"):
        thr = max(1024, int(it[1]) >> 7)
    best, cand = best_emission(emit, [it] + hist[::-1], thr)
    del plan, hist, it
    if best is None:
        out = dispatch_segment_mid(front)
        out["rings_mode"] = 0
    else:
        items = best[2]
        r1, rounds = plan_stats_b(items.sr_ctx, items.n_items)
        out = dict(front, items=items, r1=r1, rounds=rounds, rings_mode=1)
        del out["front"]  # no fallback needs FRONT's outputs any more
    out["emissions"] = [c[:2] for c in cand]
    out["thr"] = thr
    return out


def dispatch_segment_back(mid: dict) -> dict:
    """Sync the plan stats; a segment past the skew cap goes to
    ``encode_segment_device``, any other through BACK."""
    if mid["empty"]:
        return mid
    with trace.sync("skewed"):
        r1, r = (int(v) for v in torch.stack([mid["r1"], mid["rounds"]]).cpu())
    if r - r1 > host.R_CAP_MAX:  # pathological skew: one hot context
        return {"empty": False, "fallback": encode_segment_device(
            mid["data"], mid["level"], mid["chunk_input"],
            device=mid["seg_lens"].device)}
    out = back_body_b(mid["items"], mid["chunk_input"], mid["c_max"])
    return {"empty": False, "fallback": None, "out": out,
            "rings_mode": mid.get("rings_mode", 0)}


def finish_segment(data: bytes, back: dict, chunk_input: int) -> bytes:
    """Fetch BACK's outputs and assemble the payload."""
    if back.get("empty"):
        return empty_payload(chunk_input)
    if back.get("fallback") is not None:
        return back["fallback"]
    metas, words = fetch_out(back["out"])
    return assemble(data, metas[0], words[0], chunk_input,
                    back.get("rings_mode", 0))


def encode_segment_staged(
    data: bytes, level: int = 1, chunk_input: int = CHUNK_INPUT_DEFAULT,
    rings_mode: int | None = None, device: str | torch.device = "cuda",
) -> bytes:
    """Encode one segment through the staged path on `device`.  rings_mode:
    None = the level's default (OTZ2 from level 2); 0/1 force OTZ1/OTZ2."""
    device = resolve_device(device, "encode_segment_staged")
    if rings_mode is None:
        rings_mode = int(otz2_enabled(level))
    front = dispatch_segment_front(data, level, chunk_input, device)
    mid = (dispatch_segment_mid2 if rings_mode else dispatch_segment_mid)(
        front)
    return finish_segment(data, dispatch_segment_back(mid), chunk_input)


def encode_segment_device(
    data: bytes, level: int = 1, chunk_input: int = CHUNK_INPUT_DEFAULT,
    device: str | torch.device = "cuda",
) -> bytes:
    """Encode one segment as OTZ1 (rings_mode 0) on `device`, whatever the
    level: JAX's monolithic program, which has no skew cap."""
    device = resolve_device(device, "encode_segment_device")
    if not data:
        return empty_payload(chunk_input)
    mid = dispatch_segment_mid(dispatch_segment_front(data, level,
                                                      chunk_input, device))
    out = back_body_b(mid["items"], chunk_input, mid["c_max"])
    return finish_segment(data, {"out": out, "rings_mode": 0}, chunk_input)
