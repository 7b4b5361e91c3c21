"""Batched device encode in torch: B same-bucket segments per call.

Mirrors ``orz_tpu/device/batch.py`` ``encode_segments_batch``.  Levels
without OTZ2 (l0, l1, or ``rings_mode=0``): FRONT (analysis, parse, fence
walk) -> one host sync for the item bucket -> MID (item fields) -> BACK
(census, symrank, entropy, packing) -> one fetch of meta and payload words
-> host stream assembly.  With OTZ2 (``rings_mode=1``, the l2 default):
FRONT -> QUALITY (the masked re-parse schedule and the conform analyses of
its last two iterates) -> one fetch of both iterates' item counts -> MID2
(conform, repair, emit, the best-of-2 pick) -> BACK.  A segment whose
repair failed is re-encoded through the per-segment OTZ1 MID and BACK
(``device/pipeline.py``) from its FRONT outputs.  As in JAX, a batch that
holds an empty segment, or whose symrank rounds past the first C_MID
contexts exceed ``R_CAP_MAX`` in some segment (the skew check after MID or
MID2), goes whole through the per-segment staged encoder
``pipeline.encode_segment_staged``.  Payloads are byte-identical to the JAX
chain's.
"""

from __future__ import annotations

import numpy as np
import torch

from orz_tpu_torch import trace
from orz_tpu_torch.bitio import BitEncoder
from orz_tpu_torch.device import host
from orz_tpu_torch.device.host import (
    _FETCH_GRANULE,
    _bucket,
    _bucket_capacity,
    assemble_segment_np,
    pad_batch,
)
from orz_tpu_torch.ops.batched import (
    back_body_b,
    front_body_b,
    masked_plan_b,
    mid_body_b,
    plan_stats_b,
)
from orz_tpu_torch.ops.otz2 import (
    conform_mask_b,
    conform_repair_b,
    emit_items2_b,
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

# OTZ2 segments re-encoded through OTZ1 because their repair failed, since
# the last reset.
otz1_fallbacks = 0
# Batches sent whole to the staged encoder (an empty segment, or symrank
# skew), and the segments they held, since the last reset.
staged_batches = 0
staged_segments = 0


def quality_scan_body(bufs, seg_lens, mask0, ni0, head):
    """The masked plan and the head of the iteration schedule (all but the
    last two steps) as mask-carry steps: (plan, mask, ni)."""
    plan = masked_plan_b(bufs, seg_lens)
    mask, ni = mask0, ni0
    for depth in head:
        mask, ni = iter2_mask_step_b(bufs, seg_lens, depth, mask, plan)
    return plan, mask, ni


def quality_tail_body(bufs, seg_lens, plan, starts0, ni0, pk0, mask, tail,
                      c_shifts: int):
    """The final two full iterates and their conform analyses: two tuples
    (starts, n_items, pk1, bestq2, bestlen2), A the second-to-last iterate
    and B the last.  With a one-step schedule, A is the FRONT parse."""
    if len(tail) == 2:
        st_a, ni_a, pk_a, mask_a = iter2_full_step_b(bufs, seg_lens, tail[0],
                                                     mask, plan)
    else:
        st_a, ni_a, pk_a, mask_a = starts0, ni0, pk0, mask
    st_b, ni_b, pk_b, mask_b = iter2_full_step_b(bufs, seg_lens, tail[-1],
                                                 mask_a, plan)
    bq_a, bl_a = conform_mask_b(bufs, seg_lens, c_shifts, mask_a, plan)
    bq_b, bl_b = conform_mask_b(bufs, seg_lens, c_shifts, mask_b, plan)
    return (st_a, ni_a, pk_a, bq_a, bl_a), (st_b, ni_b, pk_b, bq_b, bl_b)


def quality_split(schedule) -> tuple[tuple[int, ...], tuple[int, ...], int]:
    """QUALITY's split of an OTZ2 schedule, as JAX's driver splits it: the
    head (mask-carry scan steps; JAX groups it into same-depth runs for
    ``lax.scan``, here it is a Python loop), the last two steps (full
    iterates) and the conform analyses' shift count."""
    return (tuple(schedule[:-2]), tuple(schedule[-2:]),
            OTZ2_CONFORM_SHIFTS or schedule[-1])


def m2_cap_for(ni_max: int) -> int:
    """MID2's item bucket for the larger iterate's item count."""
    ni_max = max(ni_max, 1)
    return _bucket(ni_max + max(ni_max // 4, 4096), 1 << 14, 2)


def emit_iterate(bufs, seg_lens, it, m2_cap: int):
    """Conform, repair and emit one iterate ``it`` = (starts, n_items, pk1,
    bestq2, bestlen2) at the item cap m2_cap: (items, ok, demotions)."""
    st, ni, pk, bq, bl = it
    start, kind, length, q, rep0, ro, predi, n2, ok = conform_repair_b(
        st[:, :m2_cap], ni, pk, bq, bl, bufs, seg_lens, words_mode=True)
    items = emit_items2_b(start, kind, length, q, rep0, ro, n2, pk, bufs,
                          seg_lens, predi=predi)
    return items, ok, items.n_items - ni


def mid2_body(bufs, seg_lens, it_a, it_b, m2_cap: int):
    """Conform, repair and emit the newest iterate B; when some segment's B
    failed or demoted more than max(1024, n_items/128) items (anomalous),
    emit A too and keep, per segment, B unless it failed or A demoted
    fewer.  Returns (items, ok, r1, rounds, dem_a, dem_b)."""
    items_b, ok_b, dem_b = emit_iterate(bufs, seg_lens, it_b, m2_cap)
    thr = torch.clamp(it_b[1] >> 7, min=1024)
    with trace.sync("anomalous"):
        anomalous = bool((~ok_b | (dem_b > thr)).any())
    if anomalous:
        items_a, ok_a, dem_a = emit_iterate(bufs, seg_lens, it_a, m2_cap)
        use_b = ok_b & ((dem_b <= thr) | ~ok_a | (dem_b <= dem_a))
        items = type(items_b)(*(
            torch.where(use_b.view((-1,) + (1,) * (a.dim() - 1)), b, a)
            for a, b in zip(items_a, items_b)))
        ok = ok_a | ok_b
    else:
        items, ok, dem_a = items_b, ok_b, dem_b
    r1, rounds = plan_stats_b(items.sr_ctx, items.n_items)
    return items, ok, r1, rounds, dem_a, dem_b


def without_failed(items, ok):
    """`items` with n_items 0 in the segments whose repair failed: their
    item count may pass the item cap, and BACK's output for them is
    dropped."""
    return items._replace(n_items=torch.where(ok, items.n_items, 0))


def resolve_device(device, who: str) -> torch.device:
    """`device` as a torch.device; a CUDA device without CUDA raises (no
    entry point carries on on the CPU unless asked)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: CUDA device requested but "
                           f"torch.cuda.is_available() is false")
    return device


def skewed(r1, rounds) -> bool:
    """JAX's symrank skew check: some segment's rounds past the first C_MID
    contexts exceed R_CAP_MAX (host syncs r1 and rounds)."""
    with trace.sync("skewed"):
        r1_h, r_h = torch.stack([r1, rounds]).cpu().numpy()
    return bool(((r_h - r1_h) > host.R_CAP_MAX).any())


def _run(name: str, fn):
    """The default ``stage`` of the drivers: run the stage."""
    return fn()


def fetch_out(out):
    """One fetch of BACK's meta and of the payload words it needs."""
    with trace.sync("fetch_meta"):
        metas = out.meta.cpu().numpy()
    total_words = int(metas[:, 3].max())
    k_fetch = min(out.words.shape[1],
                  -(-max(total_words, 1) // _FETCH_GRANULE) * _FETCH_GRANULE)
    with trace.sync("fetch_words"):
        words = out.words[:, :k_fetch].cpu().numpy()
    return metas, words.astype(np.uint32)


def assemble(data: bytes, meta, words, chunk_input: int,
             rings_mode: int) -> bytes:
    enc = BitEncoder()
    enc.encode_varint(len(data))
    enc.encode_varint(chunk_input)
    return assemble_segment_np(enc, meta, words, len(data), chunk_input,
                               rings_mode=rings_mode)


def encode_segments_batch(
    datas: list[bytes],
    level: int = 2,
    chunk_input: int = CHUNK_INPUT_DEFAULT,
    rings_mode: int | None = None,
    cap: int | None = None,
    device: str | torch.device = "cuda",
    stage=_run,
) -> list[bytes]:
    """Encode B segments through the batched chain on `device`; returns the
    payloads in order.  All segments share one `cap` bucket (default: the
    bucket of the largest).  rings_mode: None = the level's default (OTZ2
    from level 2); 0/1 force OTZ1/OTZ2.  Each device stage (FRONT, then
    QUALITY scan, QUALITY tail, MID2 or MID, then BACK with its fetch) runs
    as ``stage(name, fn)``, which returns ``fn()``: a caller may time it.
    The call is the span ``batch``, each stage a span of its name
    (``orz_tpu_torch.trace``)."""
    if not datas or any(d is None for d in datas):
        raise ValueError("encode_segments_batch needs a list of bytes")
    with trace.span("batch", segments=len(datas), level=level):
        return _encode_batch(datas, level, chunk_input, rings_mode, cap,
                             device, stage)


def _encode_batch(datas, level, chunk_input, rings_mode, cap, device, stage):
    from orz_tpu_torch.device import pipeline

    if rings_mode is None:
        rings_mode = int(otz2_enabled(level))
    device = resolve_device(device, "encode_segments_batch")

    def staged():  # JAX's per-segment route for the whole batch
        trace.count(globals(), "staged_batches")
        trace.count(globals(), "staged_segments", len(datas))
        with trace.span("staged"):
            return [pipeline.encode_segment_staged(d, level, chunk_input,
                                                   rings_mode=rings_mode,
                                                   device=device)
                    for d in datas]

    def run(name, fn):  # the stage's span, whatever `stage` does
        with trace.span(name):
            return stage(name, fn)

    if any(len(d) == 0 for d in datas):
        return staged()
    if cap is None:
        cap = _bucket_capacity(max(len(d) for d in datas))
    c_max = n_chunks_for(cap, chunk_input)
    with trace.span("pad_h2d"):
        bufs_np, lens_np = pad_batch(datas, cap)
        with trace.sync("h2d_bufs"):
            bufs = torch.from_numpy(bufs_np).to(device)
        with trace.sync("h2d_lens"):
            seg_lens = torch.from_numpy(lens_np).to(device)

    starts, n_items, pk1, bestq, bestro, bufs, mask0 = run(
        "FRONT", lambda: front_body_b(bufs, seg_lens, candidate_depth(level)))
    front = (starts, n_items, pk1, bestq, bestro, bufs)
    if not rings_mode:
        del mask0
        with trace.sync("m_cap"):
            m_cap = _bucket(max(int(n_items.max()), 1), 1 << 14, 2)
        items, r1, rounds = run("MID", lambda: mid_body_b(
            starts, n_items, pk1, bestq, bestro, bufs, seg_lens, m_cap))
        ok_host = np.ones(len(datas), dtype=bool)
    else:
        head, tail, c_shifts = quality_split(otz2_schedule(level))
        plan, mask, _ = run("QUALITY scan", lambda: quality_scan_body(
            bufs, seg_lens, mask0, n_items, head))
        del mask0
        it_a, it_b = run("QUALITY tail", lambda: quality_tail_body(
            bufs, seg_lens, plan, starts, n_items, pk1, mask, tail,
            c_shifts))
        del plan, mask
        with trace.sync("m2_cap"):
            m2_cap = m2_cap_for(int(torch.stack([it_a[1], it_b[1]]).max()))
        items, ok, r1, rounds = run("MID2", lambda: mid2_body(
            bufs, seg_lens, it_a, it_b, m2_cap))[:4]
        del it_a, it_b
        items = without_failed(items, ok)
        with trace.sync("ok"):
            ok_host = ok.cpu().numpy()
    if skewed(r1, rounds):
        del front, items
        return staged()
    if ok_host.all():
        del front, starts, pk1, bestq, bestro
    metas, words = run("BACK", lambda: fetch_out(
        back_body_b(items, chunk_input, c_max)))
    del items

    payloads = []
    for b, data in enumerate(datas):
        if ok_host[b]:
            with trace.span("assemble"):
                payloads.append(assemble(data, metas[b], words[b],
                                         chunk_input, rings_mode))
            continue
        # repair failed: this segment's per-segment OTZ1 encode
        trace.count(globals(), "otz1_fallbacks")
        with trace.span("otz1_fallback"):
            state = pipeline.segment_state(  # MID needs no FRONT mask
                data, level, chunk_input, c_max, seg_lens[b:b + 1],
                tuple(t[b:b + 1] for t in front) + (None,))
            payloads.append(pipeline.finish_segment(
                data, pipeline.dispatch_segment_back(
                    pipeline.dispatch_segment_mid(state)), chunk_input))
    return payloads
