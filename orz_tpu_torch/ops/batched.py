"""Torch bodies of the batched OTZ1 encoder (FRONT, MID, BACK).

Each function mirrors the function of the same name in
``orz_tpu/ops/batched.py`` on ``(B, ...)`` tensors and returns equal
values; ``tests/test_torch_*.py`` hold them to it.  The three Pallas
kernels of this path are hand-written CUDA kernels here
(``orz_tpu_torch/kernels``): K1 match depth in ``analyze_b``, K3 the fence
walk in ``front_body_b``, K5 symrank in ``back_body_b``.

Conventions that keep the results equal to the JAX ones:

- Positions and index tensors are int64 where they index, and data stays
  int32 where the JAX code keeps int32; ``torch.cumsum``/``sum`` promote to
  int64, and results are cast back where JAX stays int32.
- ``lax.sort`` is stable and lexicographic: a key pair becomes one packed
  int64 key under a stable ``torch.sort``, then payloads are gathered.
- uint32 arithmetic (the match-key hash, the packed payload words) runs in
  int64 masked to 32 bits; dwords travel as int32 bit patterns.
- Scatters with JAX's drop semantics send out-of-range indices to one
  extra column that is dropped afterwards.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orz_tpu.device.spec import (
    FENCE,
    LAZY_LEN_CAP,
    LZ_LENID_SIZE,
    LZ_MATCH_MAX_LEN,
    LZ_MATCH_MIN_LEN,
    NEG_EML_BASE,
    NEG_EML_DEPTH,
    PAD_FRONT,
    REP0_BASE,
    ROBITS_CHEAP,
    ROID_GROUP_BITS,
    WORD_SYMBOL,
)
from orz_tpu_torch.device.host import (
    C,
    C_MID,
    EXT_W,
    LCP0,
    N_DW,
    N_SYM,
    SegmentOut,
    _w_total,
)
from orz_tpu_torch.kernels.fence_walk import walk_items
from orz_tpu_torch.kernels.match_depth import (
    lcp_from_xor,
    match_depth,
    min_match_len_for_ro,
    shift_dn,
)
from orz_tpu_torch.kernels.symrank import symrank
from orz_tpu_torch.ops.huffman import canonical_codes_b, pm_code_lens_b

INT_MAX = 0x7FFFFFFF


class ByteArrays(NamedTuple):
    cctx: torch.Tensor  # int32 byte context per position
    h2: torch.Tensor  # int32 15-bit word-model key AT each position
    mkey: torch.Tensor  # int32 31-bit candidate grouping key
    dw: torch.Tensor  # int32 bit pattern of the little-endian dword


class Analysis(NamedTuple):
    cctx: torch.Tensor
    rank: torch.Tensor
    pred: torch.Tensor
    wordmatch: torch.Tensor
    bestlen: torch.Tensor
    bestro: torch.Tensor
    bestq: torch.Tensor


class Decisions(NamedTuple):
    kind: torch.Tensor
    length: torch.Tensor
    nxt: torch.Tensor


class Items(NamedTuple):
    start: torch.Tensor
    n_items: torch.Tensor
    kind: torch.Tensor
    length: torch.Tensor
    symbol: torch.Tensor
    sr_ctx: torch.Tensor
    sr_unlikely: torch.Tensor
    after_literal: torch.Tensor
    robitlen: torch.Tensor
    robits: torch.Tensor
    eml: torch.Tensor
    pred_len: torch.Tensor


class Packed(NamedTuple):
    words: torch.Tensor  # (B, W) int64 holding uint32 words
    word_base: torch.Tensor
    bitlen: torch.Tensor
    n_items: torch.Tensor


# --- flat-index helpers ------------------------------------------------------


def _positions(bsz: int, n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device).expand(bsz, n)


def bgather(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr (B, n), idx (B, m) -> arr[b, clip(idx[b], 0, n-1)]."""
    return torch.gather(arr, 1, idx.long().clamp(0, arr.shape[1] - 1))


def _bscatter(dst, idx, val, reduce: str):
    """dst.at[b, idx].<reduce>(val), out-of-range idx dropped."""
    bsz, n = dst.shape
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, n)  # dropped column
    if not isinstance(val, torch.Tensor):
        val = torch.full(idx.shape, val, dtype=dst.dtype, device=dst.device)
    out = torch.cat([dst, dst.new_zeros((bsz, 1))], dim=1)
    out.scatter_reduce_(1, idx, val.to(dst.dtype), reduce=reduce,
                        include_self=True)
    return out[:, :n]


def bscatter_max(dst, idx, val):
    return _bscatter(dst, idx, val, "amax")


def bscatter_add(dst, idx, val):
    return _bscatter(dst, idx, val, "sum")


def bscatter_min(dst, idx, val):
    return _bscatter(dst, idx, val, "amin")


def _rollr(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.roll(x, k, dims=-1)


def _rolll(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.roll(x, -k, dims=-1)


def _first_marks(sk: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones_like(sk[:, :1], dtype=torch.bool),
                      sk[:, 1:] != sk[:, :-1]], dim=1)


def _sort_back_b(pos: torch.Tensor, payloads):
    """Return payloads to position order; ``pos`` is a permutation, so the
    JAX sort by stored position is a scatter."""
    idx = pos.long()
    return tuple(torch.empty_like(p).scatter_(1, idx, p) for p in payloads)


def _mul_u32(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2^32 for int64 a, k in [0, 2^32), with no int64
    overflow: the high half of a only reaches the result's top 16 bits."""
    lo = (a & 0xFFFF) * k
    hi = ((a >> 16) * k) & 0xFFFF
    return (lo + (hi << 16)) & 0xFFFFFFFF


def _as_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).int()


# --- FRONT: analysis ---------------------------------------------------------


def byte_arrays_b(bufs: torch.Tensor) -> ByteArrays:
    """Batched byte contexts, word keys, match keys and dwords."""
    b = bufs.int()
    prev1 = _rollr(b, 1)
    prev2 = _rollr(b, 2)
    digit = (prev2 >= 48) & (prev2 <= 57)
    letter = ((prev2 | 32) >= 97) & ((prev2 | 32) <= 122)
    cctx = (prev1 & 0x7F) | ((digit | letter).int() << 7)
    h2 = (b & 0x7F) | (cctx << 7)
    bu = bufs.long()
    dw = bu | (_rolll(bu, 1) << 8) | (_rolll(bu, 2) << 16) \
        | (_rolll(bu, 3) << 24)
    h23 = ((_mul_u32(dw, 2654435761) >> 8) & 0x7FFFFF).int()
    mkey = (cctx << 23) | h23
    return ByteArrays(cctx, h2, mkey, _as_i32(dw))


def word_predictions_b(ba: ByteArrays, bufs: torch.Tensor,
                       end: torch.Tensor) -> torch.Tensor:
    """Batched unmasked word predictions.  end: (B, 1)."""
    bsz, n = bufs.shape
    x = _positions(bsz, n, bufs.device)
    valid_x = (x >= PAD_FRONT - 1) & (x < end)
    b32 = bufs.int()
    val_at = _rolll(b32, 1) | (_rolll(b32, 2) << 8)

    sk, order = torch.sort(torch.where(valid_x, ba.h2, INT_MAX), dim=1,
                           stable=True)
    sp = order.int()
    sval = torch.gather(val_at, 1, order)
    p1 = torch.where(shift_dn(sk, 1, -1) == sk, shift_dn(sp, 1, -1), -1)
    p2 = torch.where(shift_dn(sk, 2, -1) == sk, shift_dn(sp, 2, -1), -1)
    use2 = p1 > sp - 2
    u = torch.where(use2, p2, p1)
    uval = torch.where(use2, shift_dn(sval, 2, 0), shift_dn(sval, 1, 0))
    pred_s = torch.where(u >= PAD_FRONT, uval, 0)
    (pred_at_x,) = _sort_back_b(sp, (pred_s,))
    pred = _rollr(pred_at_x, 1)
    return torch.where((x >= PAD_FRONT) & (x < end), pred, 0)


def context_ranks_b(ba: ByteArrays, valid: torch.Tensor) -> torch.Tensor:
    """Batched in-context insertion ranks."""
    bsz, n = valid.shape
    x = _positions(bsz, n, valid.device)
    sk, order = torch.sort(torch.where(valid, ba.cctx, INT_MAX), dim=1,
                           stable=True)
    gstart = torch.cummax(torch.where(_first_marks(sk), x, 0), dim=1).values
    (rank,) = _sort_back_b(order, (x - gstart,))
    return torch.where(valid, rank, 0)


def _lcp_round_b(dw_flat: torch.Tensor, row: torch.Tensor, n: int,
                 qb: torch.Tensor, pb: torch.Tensor, width: int):
    """LCP over `width` bytes at (qb, pb) of segment `row` (flat gathers of
    the (B*n,) dwords, indices clipped per segment)."""

    def dword(base, off):
        return dw_flat[row * n + (base + off).clamp(0, n - 1)]

    nw = width // 4
    lcp = torch.full(qb.shape, width, dtype=torch.int64, device=qb.device)
    for t in range(nw - 1, -1, -1):
        x = dword(qb, 4 * t) ^ dword(pb, 4 * t)
        lcp = torch.where(x != 0, 4 * t + lcp_from_xor(x).long(), lcp)
    return lcp, lcp >= width


def _extend_b(dw: torch.Tensor, best_q, cur, cap_back, alive):
    """The extension stages of ``analyze_b``: every alive position extends
    its LCP0-byte match EXT_W bytes per round until it differs, hits its
    cap or the round count.  The JAX chunked straight-line stages process
    the same alive set; here it is compacted once."""
    bsz, n = dw.shape
    flat = alive.reshape(-1).nonzero().squeeze(1)
    row = flat // n
    pc = flat % n
    q = best_q.reshape(-1)[flat].long()
    scur = cur.reshape(-1)[flat].long()
    scap = cap_back.reshape(-1)[flat].long()
    salive = torch.ones_like(flat, dtype=torch.bool)
    dw_flat = dw.reshape(-1)
    for _ in range(-(-(LZ_MATCH_MAX_LEN - LCP0) // EXT_W)):
        qb = torch.where(salive, q + scur, 0)
        pb = torch.where(salive, pc + scur, 0)
        lcp, full_w = _lcp_round_b(dw_flat, row, n, qb, pb, EXT_W)
        scur = torch.minimum(torch.where(salive, scur + lcp, scur), scap)
        salive = salive & full_w & (scur < scap)
    out = cur.clone().reshape(-1)
    out[flat] = scur.to(out.dtype)
    return out.reshape(bsz, n)


def candidate_arrays_b(ba: ByteArrays, rank: torch.Tensor,
                       valid: torch.Tensor):
    """K1's inputs (msk, msp, rank_s, dw_s): every position sorted by
    (match key, position), carrying its rank and the N_DW payload dwords
    that start at it ((B, N_DW, n); JAX rolls and sorts 16 arrays)."""
    n = valid.shape[1]
    msk, order = torch.sort(torch.where(valid, ba.mkey, INT_MAX), dim=1,
                            stable=True)
    rank_s = torch.gather(rank, 1, order)
    dw_s = torch.stack([torch.gather(ba.dw, 1, (order + 4 * t) % n)
                        for t in range(N_DW)], dim=1)
    return msk, order.int(), rank_s, dw_s


def analyze_b(bufs: torch.Tensor, seg_lens: torch.Tensor,
              depth: int) -> Analysis:
    """Batched unmasked analysis (``analyze_b`` with ``mask=None``)."""
    bsz, n = bufs.shape
    end = (PAD_FRONT + seg_lens).view(-1, 1)
    p = _positions(bsz, n, bufs.device)
    valid = (p >= PAD_FRONT) & (p < end)

    ba = byte_arrays_b(bufs)
    pred = word_predictions_b(ba, bufs, end)
    b32 = bufs.int()
    wordmatch = (b32 | (_rolll(b32, 1) << 8)) == pred
    rank = context_ranks_b(ba, valid)

    msk, msp, rank_s, dw_s = candidate_arrays_b(ba, rank, valid)
    best_q_s, best_ro_s, best_len_s = match_depth(
        msk, msp, rank_s, dw_s, end.view(-1).int(), depth)
    del dw_s
    best_q, best_ro, lcp_best = _sort_back_b(
        msp, (best_q_s, best_ro_s, best_len_s))
    cap_back = torch.minimum(FENCE - ((p - PAD_FRONT) & (FENCE - 1)), end - p)

    full = (lcp_best >= LCP0) & (cap_back > LCP0) & (best_q >= 0)
    link = full & (_rolll(best_q, LCP0) == best_q + LCP0)
    cur = _extend_b(ba.dw, best_q, lcp_best, cap_back, full & ~link)
    for _ in range(-(-LZ_MATCH_MAX_LEN // LCP0)):
        cur = torch.where(link, LCP0 + _rolll(cur, LCP0), cur)

    blen = torch.clamp(cur, max=LZ_MATCH_MAX_LEN)
    has = (best_q >= 0) & (blen >= min_match_len_for_ro(best_ro)) & valid
    return Analysis(ba.cctx, rank, pred, wordmatch,
                    torch.where(has, blen, 0), torch.where(has, best_ro, 0),
                    torch.where(has, best_q, 0))


# --- FRONT: parse (decisions / walk / fields) --------------------------------


def _ilog2(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) for int32 1 <= v < 2^24 via the f32 exponent."""
    return (v.float().view(torch.int32) >> 23) - 127


def roid_of_ro(ro: torch.Tensor):
    """(roid, robitlen, robits) from the reduced offset
    (``orz_tpu/ops/parse.py`` ``roid_of_ro``)."""
    v = torch.clamp(ro, min=0) + 2
    lvl = _ilog2(v) - 1
    one = torch.ones_like(lvl)
    off = ro - ((one << (lvl + 1)) - 2)
    roid = (lvl << ROID_GROUP_BITS) + (off >> lvl)
    robits = off & ((one << lvl) - 1)
    return roid, lvl, robits


def decisions_b(an: Analysis, seg_lens: torch.Tensor, n: int) -> Decisions:
    """Batched lazy-parse decisions."""
    bsz = an.bestlen.shape[0]
    p = _positions(bsz, n, an.bestlen.device)
    end = (PAD_FRONT + seg_lens).view(-1, 1)
    is_m = an.bestlen >= LZ_MATCH_MIN_LEN
    _, robitlen, _ = roid_of_ro(an.bestro)
    lazy_len1 = an.bestlen + 1 + (robitlen < ROBITS_CHEAP).int()
    short = an.bestlen < LAZY_LEN_CAP
    lazy1 = is_m & short & (_rolll(an.bestlen, 1) >= lazy_len1)
    lazy2 = is_m & short & (_rolll(an.bestlen, 2)
                            >= lazy_len1 - an.wordmatch.int())
    m_emit = is_m & ~lazy1 & ~lazy2
    fence_room = (FENCE - ((p - PAD_FRONT) & (FENCE - 1))) >= 2
    w_emit = ~m_emit & an.wordmatch & ~lazy1 & (p + 2 <= end) & fence_room
    kind = torch.where(m_emit, 2, torch.where(w_emit, 1, 0)).int()
    length = torch.where(m_emit, an.bestlen,
                         torch.where(w_emit, 2, 1)).int()
    nxt = torch.minimum(p + length, end).int()
    return Decisions(kind, length, nxt)


def pack_fields_b(an: Analysis, dec: Decisions,
                  bufs: torch.Tensor) -> torch.Tensor:
    """kind | len-or-byte << 2 | cctx << 10 | pred8 << 18 per position."""
    lob = torch.where(dec.kind == 2, dec.length, bufs.int())
    return dec.kind | (lob << 2) | (an.cctx << 10) | ((an.pred & 0xFF) << 18)


def front_body_b(bufs: torch.Tensor, seg_lens: torch.Tensor, depth: int):
    """FRONT: (starts, n_items, pk1, bestq, bestro, bufs, mask)."""
    n = bufs.shape[1]
    an = analyze_b(bufs, seg_lens, depth)
    dec = decisions_b(an, seg_lens, n)
    starts, n_items, mask = walk_items(dec.nxt, seg_lens)
    pk1 = pack_fields_b(an, dec, bufs)
    return starts, n_items, pk1, an.bestq, an.bestro, bufs, mask


# --- MID (OTZ1) --------------------------------------------------------------


def _seg_cummax(first: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of v (0 <= v < 256) restarting at each `first`
    mark: a cummax over (segment id, v) packed into one int64 key."""
    seg = torch.cumsum(first.long(), dim=1)
    return torch.cummax(seg * 256 + v.long(), dim=1).values - seg * 256


def build_items_b(starts, n_items, pk1, bestq, bestro, bufs, seg_lens):
    """Batched item fields from the compacted starts (OTZ1 mid)."""
    bsz, mc = starts.shape
    dev = starts.device
    end = (PAD_FRONT + seg_lens).view(-1, 1)
    idx = _positions(bsz, mc, dev)
    valid = idx < n_items.view(-1, 1)
    start = torch.where(valid, starts, 0)

    f = bgather(pk1, start)
    kind = torch.where(valid, f & 3, 0)
    lob = (f >> 2) & 0xFF
    length = torch.where(
        valid, torch.where(kind == 2, lob, torch.where(kind == 1, 2, 1)), 0)
    cctx = (f >> 10) & 0xFF
    pred8 = (f >> 18) & 0xFF
    after_literal = torch.cat(
        [torch.ones((bsz, 1), dtype=torch.int32, device=dev),
         (kind[:, :-1] == 0).int()], dim=1)

    is_match = kind == 2
    q_item = torch.where(is_match, bgather(bestq, start), 0)
    dist = torch.where(is_match, start - q_item, 0)
    last_match = torch.cummax(torch.where(is_match, idx, -1), dim=1).values
    prev_match = torch.cat(
        [torch.full((bsz, 1), -1, dtype=torch.int32, device=dev),
         last_match[:, :-1]], dim=1)
    prev_dist = torch.where(prev_match >= 0, bgather(dist, prev_match), 0)
    rep0 = is_match & (dist == prev_dist) & (prev_dist > 0)

    ro = torch.where(is_match, bgather(bestro, start), 0)
    roid, robitlen_all, robits_all = roid_of_ro(ro)
    robitlen = torch.where(is_match & ~rep0, robitlen_all, 0)
    robits = torch.where(is_match & ~rep0, robits_all, 0)

    # length prediction: merge items (role 0) and match queries (role 1)
    # by target position, items first at equal keys
    q_key = torch.where(is_match & valid, q_item, INT_MAX)
    skey = torch.cat([torch.where(valid, starts, 0x7FFFFFFE), q_key], dim=1)
    srole = torch.cat([torch.zeros_like(idx), torch.ones_like(idx)], dim=1)
    spay = torch.cat([idx, idx], dim=1)
    slen = torch.cat([torch.zeros_like(idx),
                      torch.where(is_match, length, 0)], dim=1)
    _, o = torch.sort(skey.long() * 2 + srole, dim=1, stable=True)
    o_key = torch.gather(skey, 1, o)
    o_role = torch.gather(srole, 1, o)
    o_pay = torch.gather(spay, 1, o)
    o_len = torch.gather(slen, 1, o)

    last_item = torch.cummax(torch.where(o_role == 0, o_pay, -1), dim=1).values
    qslot = torch.where(o_role == 1, o_pay, mc)
    zeros1 = torch.zeros((bsz, mc + 1), dtype=torch.int32, device=dev)
    cand = bscatter_max(zeros1, qslot, torch.clamp(last_item, min=0))[:, :mc]
    hit = (bgather(start, cand) == q_item) & is_match
    expected_q = torch.where(hit & (bgather(kind, cand) == 2),
                             bgather(length, cand), 0)

    first = torch.cat([
        torch.ones((bsz, 1), dtype=torch.bool, device=dev),
        (o_key[:, 1:] != o_key[:, :-1]) | (o_role[:, 1:] != o_role[:, :-1]),
    ], dim=1)
    incl = _seg_cummax(first, o_len)
    excl = torch.where(first, 0, torch.cat(
        [torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1))
    prev_max_l = bscatter_max(zeros1, qslot,
                              torch.where(o_role == 1, excl, 0))[:, :mc]
    len_min_q = torch.where(prev_max_l > 0,
                            torch.clamp(prev_max_l + 1, max=127), 0)

    fence_room = torch.minimum(
        FENCE - ((start - PAD_FRONT) & (FENCE - 1)), end - start)
    lm = torch.minimum(torch.clamp(len_min_q, min=LZ_MATCH_MIN_LEN),
                       fence_room)
    ex = torch.clamp(expected_q, min=LZ_MATCH_MIN_LEN)
    e_pred = torch.where(
        length < lm,
        NEG_EML_BASE + (lm - 1 - length),
        torch.where(length > ex, length - lm,
                    torch.where(length < ex, length - lm + 1, 0)),
    )
    pred_ok = ~torch.any(is_match & (lm - length > NEG_EML_DEPTH), dim=1)
    eml_raw = torch.where(is_match, length - LZ_MATCH_MIN_LEN, 0)
    eml = torch.where(is_match & pred_ok.view(-1, 1), e_pred, eml_raw)
    lenid = torch.clamp(eml, max=LZ_LENID_SIZE - 1)
    symbol = torch.where(
        is_match,
        torch.where(rep0, REP0_BASE + lenid,
                    256 + roid * LZ_LENID_SIZE + lenid),
        torch.where(kind == 1, WORD_SYMBOL, lob),
    )
    sr_ctx = cctx | (after_literal << 8)
    return Items(
        torch.where(valid, starts, end), n_items, kind.int(), length.int(),
        symbol.int(), sr_ctx.int(), pred8.int(), after_literal,
        robitlen.int(), robits.int(), eml.int(), pred_ok,
    )


def plan_stats_b(sr_ctx: torch.Tensor, n_items: torch.Tensor):
    """(r1, rounds): the symrank round counts the TPU schedule buckets on
    (items of the C_MID-th and of the hottest context)."""
    bsz, m = sr_ctx.shape
    idx = _positions(bsz, m, sr_ctx.device)
    ctx = torch.where(idx < n_items.view(-1, 1), sr_ctx, C)
    cnt_g = bscatter_add(
        torch.zeros((bsz, C + 1), dtype=torch.int32, device=sr_ctx.device),
        ctx, 1)[:, :C]
    c_sorted = torch.sort(cnt_g, dim=1, descending=True).values
    return c_sorted[:, C_MID], c_sorted[:, 0]


def mid_body_b(starts, n_items, pk1, bestq, bestro, bufs, seg_lens,
               m_cap: int):
    """MID (OTZ1): items at the m_cap bucket, plus the plan stats."""
    items = build_items_b(starts[:, :m_cap], n_items, pk1, bestq, bestro,
                          bufs, seg_lens)
    r1, rounds = plan_stats_b(items.sr_ctx, items.n_items)
    return items, r1, rounds


# --- BACK: symrank / entropy / packing ---------------------------------------


def pack_items_b(coded, after_literal, kind, robitlen, robits, eml, chunk_id,
                 n_items, codesA, lensA, codesB, lensB, codesC, lensC,
                 w_total: int, lenid_escape: int) -> Packed:
    """Batched prefix-sum bit packing into big-endian uint32 words."""
    bsz, m = coded.shape
    dev = coded.device
    c_max = codesA.shape[1]
    idx = _positions(bsz, m, dev)
    valid = idx < n_items.view(-1, 1)
    cid = torch.where(valid, chunk_id, c_max - 1).long()

    ns = codesA.shape[2]
    ixAB = cid * ns + coded
    lit = after_literal == 1
    code1 = torch.where(lit, bgather(codesA.reshape(bsz, -1), ixAB),
                        bgather(codesB.reshape(bsz, -1), ixAB))
    len1 = torch.where(lit, bgather(lensA.reshape(bsz, -1), ixAB),
                       bgather(lensB.reshape(bsz, -1), ixAB))
    is_match = kind == 2
    has_ext = is_match & (eml >= lenid_escape)
    ixC = cid * ns + torch.clamp(eml, 0, codesC.shape[2] - 1)
    code3 = torch.where(has_ext, bgather(codesC.reshape(bsz, -1), ixC), 0)
    len3 = torch.where(has_ext, bgather(lensC.reshape(bsz, -1), ixC), 0)
    len2 = torch.where(is_match, robitlen, 0).long()
    code2 = torch.where(is_match, robits, 0).long()

    t_total = torch.where(valid, len1 + len2 + len3, 0)
    off_global = torch.cumsum(t_total, dim=1) - t_total
    chunk_base = bscatter_min(
        torch.full((bsz, c_max), 1 << 30, dtype=torch.int64, device=dev),
        cid, torch.where(valid, off_global, 1 << 30))
    off = off_global - bgather(chunk_base, cid)
    bitlen = bscatter_add(torch.zeros((bsz, c_max), dtype=torch.int64,
                                      device=dev), cid, t_total)
    items_per_chunk = bscatter_add(
        torch.zeros((bsz, c_max), dtype=torch.int64, device=dev), cid,
        valid.long())
    words_per_chunk = (bitlen + 31) >> 5
    word_base = torch.cumsum(words_per_chunk, dim=1) - words_per_chunk

    def shl(v, k):
        return (v << torch.clamp(k, 0, 31)) & 0xFFFFFFFF

    def shr(v, k):
        return v >> torch.clamp(k, 0, 31)

    c1, c2, c3 = code1.long(), code2, code3.long()
    l23 = len2 + len3
    lo = shl(c1, l23) | (c2 << len3) | c3
    hi = torch.where(t_total > 32, shr(c1, 32 - l23), 0)

    tt = t_total
    widx = bgather(word_base, cid) + (off >> 5)
    s = off & 31
    r = s + tt - 32
    w0 = torch.where(r <= 0, shl(lo, -r), torch.where(
        r < 32, shr(lo, r) | shl(hi, 32 - r), shr(hi, r - 32)))
    w1 = torch.where(r <= 0, 0, torch.where(
        r <= 32, shl(lo, 32 - r), shr(lo, r - 32) | shl(hi, 64 - r)))
    w2 = torch.where(r > 32, shl(lo, 64 - r), 0)
    w0 = torch.where(tt > 0, w0, 0)

    words = torch.zeros((bsz, w_total), dtype=torch.int64, device=dev)
    words = bscatter_add(words, widx, w0)
    words = bscatter_add(words, widx + 1, w1)
    words = bscatter_add(words, widx + 2, w2)
    return Packed(words & 0xFFFFFFFF, word_base, bitlen, items_per_chunk)


def entropy_stage_b(items: Items, coded, valid, chunk_id, num_counted,
                    census_order, chunk_input: int, c_max: int) -> SegmentOut:
    """Per-chunk Huffman weights, package-merge, canonical codes, packing
    and the meta row per segment."""
    bsz, m = coded.shape
    dev = coded.device
    row_ab = torch.where(
        valid, torch.where(items.after_literal == 1, chunk_id,
                           c_max + chunk_id), 2 * c_max).long()
    has_ext = valid & (items.kind == 2) & (items.eml >= LZ_LENID_SIZE - 1)
    row_c = torch.where(has_ext, chunk_id, c_max).long()
    codedc = torch.clamp(coded, 0, N_SYM - 1)
    emlc = torch.clamp(items.eml, 0, N_SYM - 1)
    w_ab = bscatter_add(
        torch.zeros((bsz, (2 * c_max + 1) * N_SYM), dtype=torch.int32,
                    device=dev), row_ab * N_SYM + codedc, 1,
    ).reshape(bsz, 2 * c_max + 1, N_SYM)
    w_c = bscatter_add(
        torch.zeros((bsz, (c_max + 1) * N_SYM), dtype=torch.int32,
                    device=dev), row_c * N_SYM + emlc, 1,
    ).reshape(bsz, c_max + 1, N_SYM)[:, :c_max]

    all_w = torch.cat([w_ab[:, : 2 * c_max], w_c], dim=1).reshape(-1, N_SYM)
    all_lens = pm_code_lens_b(all_w)
    all_codes = canonical_codes_b(all_lens).reshape(bsz, 3 * c_max, N_SYM)
    all_lens = all_lens.reshape(bsz, 3 * c_max, N_SYM)
    lensA, lensB, lensC = torch.split(all_lens, c_max, dim=1)
    codesA, codesB, codesC = torch.split(all_codes, c_max, dim=1)

    packed = pack_items_b(
        coded, items.after_literal, items.kind, items.robitlen, items.robits,
        items.eml, chunk_id, items.n_items, codesA, lensA, codesB, lensB,
        codesC, lensC, _w_total(c_max, chunk_input), LZ_LENID_SIZE - 1,
    )
    total_words = ((packed.bitlen + 31) >> 5).sum(dim=1)
    meta = torch.cat([
        torch.stack([num_counted.long(), items.pred_len.long(),
                     items.n_items.long(), total_words], dim=1),
        packed.n_items, packed.bitlen, packed.word_base,
        census_order.long(),
        lensA.reshape(bsz, -1), lensB.reshape(bsz, -1),
        lensC.reshape(bsz, -1),
    ], dim=1).int()
    return SegmentOut(meta, packed.words)


def census_b(items: Items, chunk_input: int, c_max: int):
    """(valid, chunk_id, census_order, num_counted): the chunk-0 symbol
    census that seeds every symrank context (K5's init_perm)."""
    bsz, m = items.start.shape
    dev = items.start.device
    idx = _positions(bsz, m, dev)
    valid = idx < items.n_items.view(-1, 1)
    chunk_id = torch.clamp(
        torch.div(items.start - PAD_FRONT, chunk_input, rounding_mode="floor"),
        0, c_max - 1).int()

    cens_idx = torch.where(valid & (chunk_id == 0), items.symbol, N_SYM)
    counts = bscatter_add(
        torch.zeros((bsz, N_SYM + 1), dtype=torch.int32, device=dev),
        cens_idx, 1)[:, :N_SYM]
    _, census_order = torch.sort(-torch.clamp(counts, min=1), dim=1,
                                 stable=True)
    census_order = census_order.int()
    num_counted = (counts > 1).sum(dim=1).int()
    return valid, chunk_id, census_order, num_counted


def back_body_b(items: Items, chunk_input: int, c_max: int) -> SegmentOut:
    """BACK: chunk-0 census, symrank (K5), entropy coding and packing."""
    valid, chunk_id, census_order, num_counted = census_b(items, chunk_input,
                                                          c_max)
    coded = symrank(items.symbol, items.sr_unlikely, items.sr_ctx,
                    items.n_items, census_order)
    return entropy_stage_b(items, coded, valid, chunk_id, num_counted,
                           census_order, chunk_input, c_max)
