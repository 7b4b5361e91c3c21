"""Torch bodies of the OTZ2 (item-start rings) slice: QUALITY steps and the
item-space MID2 bodies.

Each function mirrors the function of the same name in
``orz_tpu/ops/batched.py`` (the batched ``ops/otz2.py``) on ``(B, ...)``
tensors and returns equal values; ``tests/test_torch_l2.py`` holds them to
it.  The QUALITY steps run the masked analysis (K2, in
``ops/batched.analyze_b``) and the walk (K4 ``walk_mask`` for the scan's
mask carry, K3 ``walk_items`` for the final iterates).  ``lax.cond``s
become Python ``if``s on ``.any()``: each is one host sync.
"""

from __future__ import annotations

import torch

from orz_tpu_torch import trace
from orz_tpu_torch.kernels.fence_walk import walk_items
from orz_tpu_torch.kernels.seg_scan import exclusive_sum, last_marked
from orz_tpu_torch.kernels.walk_mask import walk_mask
from orz_tpu_torch.ops.batched import (
    INT_MAX,
    Items,
    MaskedPlan,
    _first_marks,
    _positions,
    analyze_b,
    bgather,
    cand_of_queries,
    decisions_b,
    lengths_and_symbols,
    merge_by_target,
    pack_fields_b,
    rep0_b,
    roid_of_ro,
    scatter_queries,
)
from orz_tpu_torch.spec import (
    LZ_MATCH_MIN_LEN,
    OTZ2_CONFORM_CAP,
    OTZ2_REPAIR_PASSES,
    PAD_FRONT,
    RING,
)

# --- QUALITY steps -------------------------------------------------------------


def iter2_mask_step_b(bufs, seg_lens, depth: int, mask_prev,
                      plan: MaskedPlan):
    """One masked re-parse, mask in, (mask, n_items) out (K4)."""
    an = analyze_b(bufs, seg_lens, depth, mask_prev, words_mode=True,
                   plan=plan)
    dec = decisions_b(an, seg_lens, bufs.shape[1])
    return walk_mask(dec.nxt, seg_lens)


def iter2_full_step_b(bufs, seg_lens, depth: int, mask_prev,
                      plan: MaskedPlan):
    """A masked re-parse emitting (starts, n_items, pk1, mask) (K3): the
    final iterates, which MID2 consumes."""
    an = analyze_b(bufs, seg_lens, depth, mask_prev, words_mode=True,
                   plan=plan)
    dec = decisions_b(an, seg_lens, bufs.shape[1])
    starts, n_items, mask = walk_items(dec.nxt, seg_lens)
    return starts, n_items, pack_fields_b(an, dec, bufs), mask


def conform_mask_b(bufs, seg_lens, depth: int, mask, plan: MaskedPlan):
    """The full-ring conform analysis of a parse: (bestq, bestlen)."""
    an = analyze_b(bufs, seg_lens, depth, mask, words_mode=True, plan=plan,
                   ro_cap=OTZ2_CONFORM_CAP)
    return an.bestq, an.bestlen


# --- item-space helpers ---------------------------------------------------------


def _expand_b(start, kind, q, head_len, tail_len, n_items):
    """Each item becomes its head (kind, head_len) followed by tail_len
    literals: (start, kind, length, q, n) of the expanded list, with the
    tail past n filled (0x7FFFFFFE, 0, 0, 0).  The owner of each expanded
    slot is the last item whose offset is at or before it (JAX scatters
    the item indices and takes a cummax).  The offsets fit int32: a valid
    item's 1 + tail_len is at most its length, and the lengths add up to
    at most the segment's bytes."""
    bsz, mc = start.shape
    idx = _positions(bsz, mc, start.device).long()
    valid = idx < n_items.view(-1, 1)
    reps = torch.where(valid, 1 + tail_len, 0).int()
    off = exclusive_sum(None, reps).long()
    total = (off[:, -1] + reps[:, -1]).int()
    sorted_off = torch.where(valid, torch.clamp(off, max=mc), mc)
    owner = torch.searchsorted(sorted_off.contiguous(), idx.contiguous(),
                               right=True) - 1
    owner = owner.clamp(min=0)
    o_start = bgather(start, owner)
    o_hlen = bgather(head_len, owner)
    within = idx - bgather(off, owner)
    is_head = within == 0
    start2 = torch.where(is_head, o_start, o_start + o_hlen + within - 1)
    kind2 = torch.where(is_head, bgather(kind, owner), 0)
    len2 = torch.where(is_head, o_hlen, 1)
    q2 = torch.where(is_head & (kind2 == 2), bgather(q, owner), 0)
    live = idx < total.view(-1, 1)
    return (torch.where(live, start2, 0x7FFFFFFE).int(),
            torch.where(live, kind2, 0).int(),
            torch.where(live, len2, 0).int(),
            torch.where(live, q2, 0).int(), total)


def _ranks_and_membership_b(start, kind, q, pk1, n_items):
    """(srank, hit, ro, cand): each item's rank among the items of its
    byte context, whether its match target is an item start, and the
    exact start-rank offset to it."""
    bsz, mc = start.shape
    idx = _positions(bsz, mc, start.device)
    valid = idx < n_items.view(-1, 1)
    cctx = (bgather(pk1, torch.where(valid, start, 0)) >> 10) & 0xFF
    sk, si = torch.sort(torch.where(valid, cctx, 0x7FFF), dim=1, stable=True)
    gstart = last_marked(None, _first_marks(sk))  # slot 0 is marked
    srank = torch.empty_like(idx).scatter_(1, si, idx - gstart)

    is_m = (kind == 2) & valid
    _, _, o_role, o_pay = merge_by_target(
        torch.where(valid, start, 0x7FFFFFFE), torch.where(is_m, q, INT_MAX))
    cand = cand_of_queries(o_role, o_pay, mc)
    hit = is_m & (bgather(start, cand) == q)
    ro = torch.where(hit, srank - bgather(srank, cand) - 1, 0)
    return srank, hit, ro, cand


def _h2_at_b(pk1, bufs, x):
    cctx = (bgather(pk1, x) >> 10) & 0xFF
    return (bgather(bufs, x).int() & 0x7F) | (cctx << 7)


def _pred_at_items_b(start, kind, length, pk1, bufs, n_items):
    """The decoder's word prediction at each item: the value of the newest
    earlier non-word item end with the same word key.  Updates (item ends)
    and queries (item starts) are sorted by (key, position); JAX's
    segmented scan is the newest update at or before each query in its
    key group."""
    bsz, mc = start.shape
    n = bufs.shape[1]
    idx = _positions(bsz, mc, start.device)
    valid = idx < n_items.view(-1, 1)
    s = torch.where(valid, start, 0)
    e = torch.clamp(s + length, 0, n - 1)
    upd = valid & (kind != 1)

    ukey = torch.where(upd, _h2_at_b(pk1, bufs, e - 3), INT_MAX)
    uval = (bgather(bufs, torch.clamp(e - 2, 0, n - 1)).int()
            | (bgather(bufs, torch.clamp(e - 1, 0, n - 1)).int() << 8))
    qkey = torch.where(valid, _h2_at_b(pk1, bufs, torch.clamp(s - 1, min=0)),
                       INT_MAX)
    upos = torch.where(upd, e, 0x3FFFFFFF)
    key1 = torch.cat([ukey, qkey], dim=1)
    key2 = torch.cat([upos << 1, (s << 1) | 1], dim=1)
    pay = torch.cat([uval, idx], dim=1)
    _, o = torch.sort((key1.long() << 31) | key2.long(), dim=1, stable=True)
    k1 = torch.gather(key1, 1, o)
    p_ = torch.gather(pay, 1, o)
    is_q = o >= mc  # the query half carries odd key2
    u = last_marked(_first_marks(k1), ~is_q)
    val = torch.where(u >= 0, torch.gather(p_, 1, u.long().clamp(min=0)), 0)
    return scatter_queries(is_q, p_, val, mc)


def conform_repair_b(starts, n_items, pk1, bestq2, bestlen2, bufs, seg_lens,
                     repair_passes: int = OTZ2_REPAIR_PASSES,
                     words_mode: bool = False):
    """Re-target each match of a parse to its conform analysis (demoting it
    to literals where the conform found none), then demote, pass by pass,
    every match whose target is no item start or lies past RING and (in
    words_mode) every word the decoder would mispredict.  Returns (start,
    kind, length, q, rep0, ro, predi, n, ok); ok is false for a segment
    that overflowed ``starts``' width or kept a violation."""
    bsz, mc = starts.shape
    n = bufs.shape[1]
    idx = _positions(bsz, mc, starts.device)
    valid = idx < n_items.view(-1, 1)
    start = torch.where(valid, starts, 0)

    f = bgather(pk1, start)
    kind = torch.where(valid, f & 3, 0)
    lob = (f >> 2) & 0xFF
    length = torch.where(
        valid, torch.where(kind == 2, lob, torch.where(kind == 1, 2, 1)), 0)
    is_m = kind == 2
    q2 = torch.where(is_m, bgather(bestq2, start), 0)
    bl2 = torch.where(is_m, bgather(bestlen2, start), 0)
    has = is_m & (bl2 >= LZ_MATCH_MIN_LEN)
    new_len = torch.where(has, torch.minimum(length, bl2), length)
    demote = is_m & ~has
    head_kind = torch.where(demote, 0, kind)
    head_len = torch.where(demote, 1, new_len)
    tail_len = torch.where(is_m, length - head_len, 0)
    start, kind, length, q, n2 = _expand_b(start, head_kind, q2, head_len,
                                           tail_len, n_items)
    ok = n2 <= mc

    def violations(start, kind, length, q, n2):
        rep0 = rep0_b(start, kind, q, n2)
        _, hit, ro, _ = _ranks_and_membership_b(start, kind, q, pk1, n2)
        live = idx < n2.view(-1, 1)
        viol = (kind == 2) & live & ~rep0 & (~hit | (ro >= RING))
        predi = torch.zeros_like(idx)
        if words_mode:
            predi = _pred_at_items_b(start, kind, length, pk1, bufs, n2)
            sc = torch.where(live, start, 0)
            pair = (bgather(bufs, sc).int()
                    | (bgather(bufs, torch.clamp(sc + 1, 0, n - 1)).int()
                       << 8))
            viol = viol | ((kind == 1) & live & (predi != pair))
        return viol, rep0, hit, ro, predi

    any_viol = True
    for _ in range(repair_passes):
        if not any_viol:
            break
        with trace.sync("repair_ok"):
            some_ok = bool(ok.any())
        if not some_ok:
            break
        viol = violations(start, kind, length, q, n2)[0]
        with trace.sync("repair_viol"):
            any_viol = bool(viol.any())
        if any_viol:
            start, kind, length, q, n2 = _expand_b(
                start, torch.where(viol, 0, kind), q,
                torch.where(viol, 1, length),
                torch.where(viol, length - 1, 0), n2)
        ok = ok & (n2 <= mc)

    resid, rep0, hit, ro, predi = violations(start, kind, length, q, n2)
    ok = ok & ~resid.any(dim=1)
    ro = torch.where((kind == 2) & ~rep0 & hit, ro, 0)
    return start, kind, length, q, rep0, ro, predi, n2, ok


def emit_items2_b(start, kind, length, q, rep0, ro, n_items, pk1, bufs,
                  seg_lens, predi=None) -> Items:
    """Item fields of a repaired OTZ2 parse (the counterpart of
    ``build_items_b``)."""
    bsz, mc = start.shape
    dev = start.device
    end = (PAD_FRONT + seg_lens).view(-1, 1)
    idx = _positions(bsz, mc, dev)
    valid = idx < n_items.view(-1, 1)
    startc = torch.where(valid, start, 0)
    f = bgather(pk1, startc)
    cctx = (f >> 10) & 0xFF
    pred8 = (f >> 18) & 0xFF if predi is None else predi & 0xFF
    kind = torch.where(valid, kind, 0)
    is_match = kind == 2
    after_literal = torch.cat(
        [torch.ones((bsz, 1), dtype=torch.int32, device=dev),
         (kind[:, :-1] == 0).int()], dim=1)
    roid, robitlen_all, robits_all = roid_of_ro(ro)
    robitlen = torch.where(is_match & ~rep0, robitlen_all, 0)
    robits = torch.where(is_match & ~rep0, robits_all, 0)
    eml, symbol, pred_ok = lengths_and_symbols(
        start, valid, kind, length, q, rep0, roid,
        bgather(bufs, startc).int(), end)
    sr_ctx = cctx | (after_literal << 8)
    return Items(
        torch.where(valid, start, end).int(), n_items, kind.int(),
        length.int(), symbol, sr_ctx.int(), pred8.int(), after_literal,
        robitlen.int(), robits.int(), eml, pred_ok,
    )
