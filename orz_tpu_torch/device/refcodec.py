"""Sequential numpy reference model of the OTZ segment format.

This file IS the format specification: the device encoders must produce a
byte-identical stream, and the decoders (this one, and the native C++ one
built from csrc/otz_core.cpp) must invert it bit-exactly.  It is the port's
copy of orz_tpu/device/refcodec.py, importing numpy and the port's host
modules only (no torch, no jax); tests/test_torch_refcodec.py pins it to
the original, tests/test_torch_slice.py holds the port's payloads to it on
the CPU and chip_smoke.py on the GPU.  device/container.py decodes with
decode_segment_ref when the native decoder cannot be built.  The stage
names in its comments (ops/analyze.py, ops/parse.py, ops/match_pallas.py)
are the JAX package's; their torch bodies are ops/batched.py, ops/otz2.py
and kernels/.

An OTZ segment is self-contained (fresh model state) and compresses up to a
few tens of MB.  Segments are framed by the parallel container
(pcontainer.py) which is the block-data-parallel scaling axis.

Segment bit-stream (MSB-first u32 words, same bit substrate as ORZ,
reference src/coder.rs:159-216):

    varint raw_len
    varint chunk_input                      # entropy-chunk size in input bytes
    [raw_len == 0 ends here]
    1 bit pred_len                          # length prediction active
    1 bit rings_mode                        # 1: item-start rings (spec.py OTZ2)
    1 bit words_mode                        # 1: word table sampled at item
                                            #    ends (the reference's rule,
                                            #    src/lz.rs:203,233); 0: at
                                            #    every position (bytes-only)
    varint num_counted                      # symbol census of chunk 0's items
    9 bits x num_counted                    # (reference src/lz.rs:238-265)
    per chunk (ceil(raw_len / chunk_input) of them):
        varint n_items
        huffman table A (431 syms, after_literal=1)
        huffman table B (431 syms, after_literal=0)
        huffman table C (240 syms, match length extension)
        per item: huff A/B code; [match] robits raw bits;
                  [lenid == 5] huff C code

Model semantics (all bytes-only; b is the padded buffer, data in
[F, F+L), zeros elsewhere; F = PAD_FRONT):

    cctx(p)   = (b[p-1] & 0x7F) | alnum(b[p-2]) << 7
    h2(x)     = (b[x] & 0x7F) | cctx(x) << 7          # 15-bit word key at x
    word model: for EVERY position u, the update word[h2(u)] = (b[u+1],
        b[u+2]) becomes visible at positions p >= u+3.  The prediction at p
        is word[h2(p-1)].
    rings: rings_mode=0 inserts EVERY position q into ring[cctx(q)];
        rings_mode=1 (OTZ2) inserts only ITEM STARTS, as each item is
        decoded.  The reduced offset of q seen from p (same context c) is
        the number of ring-inserted context-c positions strictly between
        q and p; it must be < RING (32766; extended ROID schedule, spec.py).
    candidates(p): among the last D positions q < p with
        match_key(q) == match_key(p) (cctx + hashed dword), keep those with
        reduced offset < RING whose SCORE_W-byte LCP meets the offset's
        price gate (min_match_len_for_ro); score by (lcp, then recency), extend
        the winner to LZ_MATCH_MAX_LEN, cap by segment end; the final match
        must still meet the gate.
    parse (mirrors the reference lazy heuristics, src/lz.rs:113-118):
        if bestlen(p) >= 4:
            if bestlen(p) < 120:
                lazy_len1 = bestlen(p) + 1 + (robitlen(p) < 8)
                lazy1 = bestlen(p+1) >= lazy_len1
                lazy2 = bestlen(p+2) >= lazy_len1 - wordmatch(p)
            MATCH unless lazy1 or lazy2
        no match: WORD if wordmatch(p) and not (bestlen(p) >= 4 and lazy1)
                  and p+2 <= end, else LITERAL
    items: literal -> symbol b[p], len 1, after_literal := True
           word    -> symbol WORD_SYMBOL (430), len 2, after_literal := False
           match   -> symbol 256 + roid*6 + min(5, len-4), len bytes,
                      after_literal := False
    symrank context = cctx(p) | after_literal << 8 (state at the item,
    initial True); unlikely symbol = low byte of the word prediction.
    symrank transform and update are identical to ORZ's
    (reference src/symrank.rs:38-97, golden/symrank.py).
    Huffman code lengths are optimal 15-bit-limited lengths from the
    vectorized package-merge (device/pm_huffman.py); canonical code
    assignment as ORZ (reference src/huffman.rs:118-141).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from orz_tpu_torch.constants import HUFFMAN_MAX_CODE_LEN
from orz_tpu_torch.device.pm_huffman import pm_code_lens
from orz_tpu_torch.spec import (
    CHUNK_INPUT_DEFAULT,
    FENCE,
    LAZY_LEN_CAP,
    REP0_BASE,
    LZ_LENID_SIZE,
    LZ_MATCH_MAX_LEN,
    LZ_MATCH_MIN_LEN,
    NEG_EML_BASE,
    NEG_EML_DEPTH,
    NUM_CONTEXTS,
    OTZ2_RO_CAP,
    TABC_SIZE,
    PAD_FRONT,
    PAD_TAIL,
    RING,
    ROBITS_CHEAP,
    ROID_DEC,
    ROID_ENC,
    SYMRANK_NUM_SYMBOLS,
    WORD_SYMBOL,
    WORD_TABLE_SIZE,
    candidate_depth,
    cctx_all,
    h2_all,
    match_key_all,
    min_match_len_for_ro,
    n_chunks_for,
)
from orz_tpu_torch.bitio import BitDecoder, BitEncoder
from orz_tpu_torch.golden.huffman import HuffmanDecoding, canonical_encodings
from orz_tpu_torch.golden.symrank import SymRankState


def pad_segment(data: bytes) -> np.ndarray:
    buf = np.zeros(PAD_FRONT + len(data) + PAD_TAIL, dtype=np.uint8)
    buf[PAD_FRONT : PAD_FRONT + len(data)] = np.frombuffer(data, dtype=np.uint8)
    return buf


@dataclass
class Analysis:
    """Per-position arrays over the padded buffer (the phase-1 contract the
    JAX analyze kernels must reproduce exactly)."""

    cctx: np.ndarray
    rank: np.ndarray  # rank within context at time p (0-based)
    pred: np.ndarray  # predicted 2-byte word (LE int)
    wordmatch: np.ndarray  # bool: b[p..p+1] == pred
    bestlen: np.ndarray  # best match length (capped by end), 0 if none
    bestro: np.ndarray  # reduced offset of winner (valid iff bestlen >= 4)
    bestq: np.ndarray  # winning match position (for rep-distance coding)


@dataclass
class Items:
    """Item arrays (the phase-2/3 contract)."""

    start: np.ndarray  # absolute position in padded buffer
    kind: np.ndarray  # 0 literal, 1 word, 2 match
    length: np.ndarray
    symbol: np.ndarray  # pre-symrank symbol
    sr_ctx: np.ndarray
    sr_unlikely: np.ndarray
    after_literal: np.ndarray  # table selector (state at item)
    robitlen: np.ndarray
    robits: np.ndarray
    eml: np.ndarray  # encoded/predicted match length code; huff C when >= 5
    coded: np.ndarray = field(default=None)  # post-symrank symbol
    pred_len: bool = True  # length prediction active (segment header bit)


# Candidate scoring window in bytes (must equal ops/analyze.py LCP0 /
# ops/match_pallas.py N_DW*4: candidates are ranked by their LCP within
# this window, full-window winners extended to the true length afterwards).
SCORE_W = 64


def analyze_ref(buf: np.ndarray, seg_len: int, depth: int,
                start_mask: np.ndarray | None = None,
                words_mode: int = 0, near_depth: int = 0,
                ro_cap: int | None = None) -> Analysis:
    """Sequential per-position analysis (the oracle for ops/analyze.py).

    start_mask (OTZ2, spec.py): candidates are restricted to positions in
    the mask, scanned within the last `depth` same-key positions (matching
    the device's masked shift window).  Gates and bestro then use the
    START-RANK ESTIMATE over the mask (number of masked same-context
    positions strictly between q and p) — the final-item start rank differs
    from it only by demoted literals, and emission recomputes the exact
    value (parse_ref rings_mode=1).

    words_mode=1 (requires start_mask): word-table updates happen only at
    mask positions s (the previous parse's item starts, approximating the
    decoder's item-end rule: the decoder additionally skips updates after
    WORD items — emission validates word items against the exact final
    state and demotes mismatches).

    near_depth > 0 (requires start_mask): window entries past near_depth
    are considered only when the QUERY position is itself masked (the
    device kernel's deep-window gating, ops/match_pallas.py near_depth)."""
    n = len(buf)
    end = PAD_FRONT + seg_len
    cctx = cctx_all(buf)
    h2 = h2_all(buf)
    mkey = match_key_all(buf)

    rank = np.zeros(n, dtype=np.int64)
    pred = np.zeros(n, dtype=np.int64)
    bestlen = np.zeros(n, dtype=np.int64)
    bestro = np.zeros(n, dtype=np.int64)
    bestq = np.zeros(n, dtype=np.int64)

    ctx_count = np.zeros(NUM_CONTEXTS, dtype=np.int64)
    scnt_ctx = np.zeros(NUM_CONTEXTS, dtype=np.int64)  # masked per-ctx counts
    scnt_pos = np.zeros(n, dtype=np.int64)  # masked count before q, at masked q
    words = np.zeros(WORD_TABLE_SIZE, dtype=np.int64)
    chains: dict = {}

    mask_starts = (np.nonzero(start_mask)[0]
                   if (words_mode and start_mask is not None) else None)
    next_ms = 0
    for p in range(PAD_FRONT, end):
        if mask_starts is None:
            # word update for u = p-3 becomes visible now
            u = p - 3
            if u >= PAD_FRONT:
                words[h2[u]] = int(buf[u + 1]) | int(buf[u + 2]) << 8
        else:
            # words_mode=1: one update per mask start s <= p, at u = s-3
            while next_ms < len(mask_starts) and mask_starts[next_ms] <= p:
                u = int(mask_starts[next_ms]) - 3
                if u >= PAD_FRONT - 2:
                    words[h2[u]] = int(buf[u + 1]) | int(buf[u + 2]) << 8
                next_ms += 1
        pred[p] = words[h2[p - 1]]
        rank[p] = ctx_count[cctx[p]]

        # candidate search among the last `depth` same-key positions.
        # Match lengths are capped by the parse fence (and segment end)
        # BEFORE scoring, so far offsets are never spent on capped lengths
        # and no item ever crosses a fence (ops/analyze.py mirrors this).
        cap = min(FENCE - ((p - PAD_FRONT) % FENCE), end - p)
        chain = chains.get(mkey[p])
        bestw, bro, blen, bq = 0, -1, 0, 0
        # far tier (conform rescue, ops/match_pallas.py two-tier cap):
        # candidates past OTZ2_RO_CAP rank strictly below every near one
        bestw_f, bro_f, blen_f, bq_f = 0, -1, 0, 0
        eff_cap = OTZ2_RO_CAP if ro_cap is None else ro_cap
        win = depth
        if near_depth and start_mask is not None and not start_mask[p]:
            win = min(depth, near_depth)  # deep window is for mask queries
        if chain:
            for q in chain[-1 : -win - 1 : -1]:
                far = False
                if start_mask is not None:
                    if not start_mask[q]:
                        continue
                    ro = scnt_ctx[cctx[p]] - scnt_pos[q] - 1
                    if ro >= eff_cap:
                        continue
                    far = ro >= OTZ2_RO_CAP
                else:
                    ro = rank[p] - 1 - rank[q]
                if ro >= RING:
                    continue
                lw = min(_lcp(buf, q, p, SCORE_W), cap)
                if lw < min_match_len_for_ro(ro):
                    continue  # far offsets must pay for their raw bits
                if far:
                    if lw > bestw_f:
                        bestw_f, bro_f, bq_f = lw, ro, q
                        blen_f = (min(_lcp(buf, q, p, LZ_MATCH_MAX_LEN), cap)
                                  if lw >= SCORE_W else lw)
                elif lw > bestw:
                    bestw, bro, bq = lw, ro, q
                    if lw >= SCORE_W:
                        blen = min(_lcp(buf, q, p, LZ_MATCH_MAX_LEN), cap)
                    else:
                        blen = lw
        if bro < 0 and bro_f >= 0:  # rescue: no near candidate at all
            bro, blen, bq = bro_f, blen_f, bq_f
        if bro >= 0:
            if blen >= min_match_len_for_ro(bro):
                bestlen[p] = blen
                bestro[p] = bro
                bestq[p] = bq

        chains.setdefault(mkey[p], []).append(p)
        ctx_count[cctx[p]] += 1
        if start_mask is not None and start_mask[p]:
            scnt_pos[p] = scnt_ctx[cctx[p]]
            scnt_ctx[cctx[p]] += 1

    b32 = buf.astype(np.int64)
    nxt = np.roll(b32, -1)
    nxt[-1] = 0
    cur_word = b32 + (nxt << 8)
    # plain equality, as the reference (src/lz.rs:133): an all-zero
    # prediction legitimately matches zero bytes; the parse guards word
    # items to p+2 <= end so pad bytes are never emitted.
    wordmatch = cur_word == pred
    return Analysis(cctx, rank, pred, wordmatch, bestlen, bestro, bestq)


def _lcp(buf: np.ndarray, q: int, p: int, cap: int) -> int:
    a = buf[q : q + cap]
    b = buf[p : p + cap]
    neq = a != b
    i = int(np.argmax(neq))
    return cap if not neq[i] else i


def parse_walk(an: Analysis, buf: np.ndarray, seg_len: int):
    """Sequential parse walk -> (start, kind, length) arrays (the oracle for
    ops/parse.py decisions + walk_items)."""
    end = PAD_FRONT + seg_len
    starts: List[int] = []
    kinds: List[int] = []
    lengths: List[int] = []

    p = PAD_FRONT
    while p < end:
        blen = int(an.bestlen[p])
        is_match = blen >= LZ_MATCH_MIN_LEN
        lazy1 = False
        if is_match and blen < LAZY_LEN_CAP:
            robitlen = int(ROID_ENC[an.bestro[p], 1])
            lazy_len1 = blen + 1 + (1 if robitlen < ROBITS_CHEAP else 0)
            lazy1 = p + 1 < end and int(an.bestlen[p + 1]) >= lazy_len1
            lazy2 = p + 2 < end and int(an.bestlen[p + 2]) >= lazy_len1 - int(an.wordmatch[p])
            if lazy1 or lazy2:
                is_match = False
        if is_match:
            starts.append(p)
            kinds.append(2)
            lengths.append(blen)
            p += blen
        elif (an.wordmatch[p] and not lazy1 and p + 2 <= end
              and FENCE - ((p - PAD_FRONT) % FENCE) >= 2):
            starts.append(p)
            kinds.append(1)
            lengths.append(2)
            p += 2
        else:
            starts.append(p)
            kinds.append(0)
            lengths.append(1)
            p += 1

    return (np.asarray(starts, dtype=np.int64), np.asarray(kinds, dtype=np.int64),
            np.asarray(lengths, dtype=np.int64))


def _rep0_flags(start, kind, q_of):
    """(dist, prev_dist, rep0) over the item arrays, stream order."""
    dist = np.where(kind == 2, start - q_of, 0)
    prev_dist = np.zeros(len(start), dtype=np.int64)
    last = 0
    for i in range(len(start)):
        prev_dist[i] = last
        if kind[i] == 2:
            last = dist[i]
    rep0 = (kind == 2) & (dist == prev_dist) & (prev_dist > 0)
    return dist, prev_dist, rep0


def _start_ranks(start, cctx):
    """srank[i] = number of earlier item starts with the same context (the
    exact OTZ2 ring rank of item i's start)."""
    c = cctx[start]
    srank = np.zeros(len(start), dtype=np.int64)
    # starts are ascending; vectorized grouped occurrence index
    order = np.argsort(c, kind="stable")
    cs = c[order]
    first = np.ones(len(cs), dtype=bool)
    first[1:] = cs[1:] != cs[:-1]
    idxs = np.arange(len(cs))
    occ = idxs - np.maximum.accumulate(np.where(first, idxs, 0))
    srank[order] = occ
    return srank


def _demote_spans(start, kind, length, q, demote):
    """Expand every demoted item's span into length-1 literal items (other
    items pass through).  Only ADDS item starts — the monotonicity that makes
    the OTZ2 repair loop converge (spec.py)."""
    reps = np.where(demote, length, 1)
    ends = np.cumsum(reps)
    base = np.repeat(start, reps)
    off = np.arange(int(ends[-1]) if len(reps) else 0, dtype=np.int64) \
        - np.repeat(ends - reps, reps)
    new_start = base + off
    new_kind = np.repeat(np.where(demote, 0, kind), reps)
    new_length = np.where(new_kind == 0, 1, np.repeat(length, reps))
    new_q = np.repeat(np.where(demote, 0, q), reps)
    return new_start, new_kind, new_length, new_q


def conform_items(an: Analysis, start, kind, length):
    """OTZ2 conform step (spec.py): hold the parse's item boundaries fixed
    and re-target every match at the masked analysis `an` (whose candidates
    all lie on ring-inserted starts).  A match whose masked candidate is
    shorter than the item shrinks to it — the tail becomes length-1 literal
    items; one with no masked candidate demotes entirely.  Both only ADD
    starts.  Returns (start, kind, length, q)."""
    bl = np.where(kind == 2, an.bestlen[start], 0)
    q = np.where(kind == 2, an.bestq[start], 0)
    has = (kind == 2) & (bl >= LZ_MATCH_MIN_LEN)
    new_len = np.where(has, np.minimum(length, bl), length)
    demote = (kind == 2) & ~has
    # shrink: emit the kept match, then expand the tail via a demoted
    # pseudo-item covering [start+new_len, start+length)
    shrink = has & (new_len < length)
    if shrink.any():
        ts = (start + new_len)[shrink]
        tl = (length - new_len)[shrink]
        start = np.concatenate([start, ts])
        kind = np.concatenate([kind, np.full(len(ts), 2, np.int64)])
        length = np.concatenate([new_len, tl])
        q = np.concatenate([q, np.zeros(len(ts), np.int64)])
        demote = np.concatenate([demote, np.ones(len(ts), bool)])
        order = np.argsort(start, kind="stable")
        start, kind, length, q, demote = (a[order] for a in (start, kind, length, q, demote))
    else:
        length = new_len
    return _demote_spans(start, kind, length, q, demote)


def repair_items(an: Analysis, start, kind, length, q):
    """OTZ2 demotion repair (spec.py): demote every non-rep0 match whose
    target is not an item start — or whose exact start-rank reduced offset
    reaches RING — to length-1 literal items, until no violations remain
    (after conform_items, only RING overflow can still occur).

    Returns (start, kind, length, q, ro_exact, rep0) with ro_exact the final
    start-rank reduced offsets (0 for rep0/non-match items), or None if
    OTZ2_REPAIR_PASSES passes did not converge (caller falls back to
    rings_mode=0)."""
    from orz_tpu_torch.spec import OTZ2_REPAIR_PASSES

    for _ in range(OTZ2_REPAIR_PASSES + 1):
        _, _, rep0 = _rep0_flags(start, kind, q)
        srank = _start_ranks(start, an.cctx)
        # membership + rank of each match target among starts
        idx = np.searchsorted(start, q)
        idxc = np.minimum(idx, max(len(start) - 1, 0))
        q_is_start = (kind == 2) & (len(start) > 0) & (start[idxc] == q)
        ro = np.where(q_is_start, srank - srank[idxc] - 1, 0)
        # format bound is RING, not OTZ2_RO_CAP: an offset that drifted past
        # the search cap (repair adds starts) still beats demotion by far
        viol = (kind == 2) & ~rep0 & (~q_is_start | (ro >= RING))
        if not viol.any():
            ro_exact = np.where((kind == 2) & ~rep0 & q_is_start, ro, 0)
            return start, kind, length, q, ro_exact, rep0
        start, kind, length, q = _demote_spans(start, kind, length, q, viol)
    return None


def _words1_pred_at_items(buf, h2, start, kind, length):
    """The decoder's words_mode=1 prediction at each item start: the word
    table updates once per ITEM END (key h2(end-3)), skipping ends of WORD
    items — refcodec decode / csrc/otz_core.cpp words_flag=1."""
    words = np.zeros(WORD_TABLE_SIZE, dtype=np.int64)
    m = len(start)
    pred = np.zeros(m, dtype=np.int64)
    for i in range(m):
        s = int(start[i])
        pred[i] = words[h2[s - 1]]
        if kind[i] != 1:
            u = s + int(length[i]) - 3
            words[h2[u]] = int(buf[u + 1]) | int(buf[u + 2]) << 8
    return pred


def parse_ref(an: Analysis, buf: np.ndarray, seg_len: int,
              rings_mode: int = 0, walk=None,
              words_mode: int = 0) -> Items | None:
    """Sequential parse + item emission (the oracle for ops/parse.py).

    rings_mode=1 (OTZ2): `an` must be a masked analyze_ref pass whose mask
    is exactly the start set of `walk` (the boundaries being emitted);
    conform_items re-targets matches onto masked candidates, then demotion
    repair makes reduced offsets exact start ranks.  Returns None when
    repair does not converge (fall back to rings_mode=0).

    words_mode=1 (requires rings_mode=1): word items are VALIDATED against
    the decoder's exact item-end word state (the parse chose them under the
    mask approximation); mismatches demote to literals, which changes item
    ends, so validation and offset repair iterate to a joint fixed point
    (both only add starts — monotone).  sr_unlikely comes from the same
    exact state."""
    end = PAD_FRONT + seg_len
    start, kind, length = walk if walk is not None else parse_walk(an, buf, seg_len)

    if rings_mode:
        start, kind, length, q_arr = conform_items(an, start, kind, length)
        if words_mode:
            # combined per-pass schedule (MUST match ops/otz2.conform_repair
            # demotion-for-demotion: word validity is not monotone under
            # added starts, so the schedule is part of the device contract):
            # each pass demotes offset violations AND word-prediction
            # mismatches together.
            from orz_tpu_torch.spec import OTZ2_REPAIR_PASSES

            h2 = h2_all(buf)

            def _viol(start, kind, length, q_arr):
                _, _, rep0 = _rep0_flags(start, kind, q_arr)
                srank = _start_ranks(start, an.cctx)
                idx = np.searchsorted(start, q_arr)
                idxc = np.minimum(idx, max(len(start) - 1, 0))
                q_is_start = (kind == 2) & (len(start) > 0) & (start[idxc] == q_arr)
                ro = np.where(q_is_start, srank - srank[idxc] - 1, 0)
                viol = (kind == 2) & ~rep0 & (~q_is_start | (ro >= RING))
                predi = _words1_pred_at_items(buf, h2, start, kind, length)
                pair = (buf[start].astype(np.int64)
                        | buf[np.minimum(start + 1, len(buf) - 1)].astype(np.int64) << 8)
                viol |= (kind == 1) & (predi != pair)
                ro_ex = np.where((kind == 2) & ~rep0 & q_is_start, ro, 0)
                return viol, rep0, ro_ex, predi

            for _ in range(OTZ2_REPAIR_PASSES):
                viol, rep0, ro_exact, predi = _viol(start, kind, length, q_arr)
                if not viol.any():
                    break
                start, kind, length, q_arr = _demote_spans(
                    start, kind, length, q_arr, viol)
            viol, rep0, ro_exact, predi = _viol(start, kind, length, q_arr)
            if viol.any():
                return None
            pred_n = np.zeros(len(buf), dtype=np.int64)
            pred_n[start] = predi
            return _emit_items(an.cctx, pred_n, buf, seg_len, start, kind,
                               length, q_arr, ro_exact, rep0)
        rep = repair_items(an, start, kind, length, q_arr)
        if rep is None:
            return None
        start, kind, length, q_arr, ro_exact, rep0 = rep
        ro = ro_exact
    else:
        q_arr = np.where(kind == 2, an.bestq[start], 0)
        _, _, rep0 = _rep0_flags(start, kind, q_arr)
        # the analysis's every-position ranks (bestro at non-match starts: 0)
        ro = an.bestro[start]
    return _emit_items(an.cctx, an.pred, buf, seg_len, start, kind, length,
                       q_arr, ro, rep0)


def _emit_items(cctx_arr, pred_arr, buf, seg_len, start, kind, length, q_arr,
                ro, rep0) -> Items:
    """Item emission from a resolved parse: length prediction, symbols,
    symrank contexts (shared by parse_ref and the sequential OTZ2 encoder)."""
    end = PAD_FRONT + seg_len
    after_literal = np.empty(len(start), dtype=np.int64)
    if len(start):
        after_literal[0] = 1
        after_literal[1:] = kind[:-1] == 0

    # length prediction (the reference's len_min/len_expected side-info,
    # src/matcher.rs:32-50, src/lz.rs:173-177): both values are functions of
    # the decoded item stream, so the decoder reconstructs them exactly.
    # expected(q) = length coded if a match item started at q, else 0;
    # len_min(q) = running min(127, max earlier match length against q + 1).
    eml = np.where(kind == 2, length - LZ_MATCH_MIN_LEN, 0)
    expected_arr = np.zeros(len(buf), dtype=np.int64)
    len_min_arr = np.zeros(len(buf), dtype=np.int64)
    pred_ok = True
    for i in range(len(start)):
        if kind[i] != 2:
            continue
        q = q_arr[i]
        # len_min floor capped by the fence room at the consuming position:
        # fence-truncated matches would otherwise break the invariant
        room = min(FENCE - ((int(start[i]) - PAD_FRONT) % FENCE), end - int(start[i]))
        lm = min(max(len_min_arr[q], LZ_MATCH_MIN_LEN), room)
        ex = max(expected_arr[q], LZ_MATCH_MIN_LEN)
        L = length[i]
        if L < lm:  # below the floor: the negative band (spec.NEG_EML_BASE)
            if lm - L > NEG_EML_DEPTH:  # beyond its reach (vanishingly
                pred_ok = False  # rare): header bit disables prediction
                break
            e = NEG_EML_BASE + (lm - 1 - L)
        elif L > ex:
            e = L - lm
        elif L < ex:
            e = L - lm + 1
        else:
            e = 0
        eml[i] = e
        if len_min_arr[q] <= L:
            len_min_arr[q] = min(L + 1, 127)
        expected_arr[start[i]] = L
    if not pred_ok:
        eml = np.where(kind == 2, length - LZ_MATCH_MIN_LEN, 0)

    roid = np.where(kind == 2, ROID_ENC[ro, 0], 0)
    robitlen = np.where((kind == 2) & ~rep0, ROID_ENC[ro, 1], 0)
    robits = np.where((kind == 2) & ~rep0, ROID_ENC[ro, 2], 0)
    lenid = np.minimum(eml, LZ_LENID_SIZE - 1)
    symbol = np.where(
        kind == 2,
        np.where(rep0, REP0_BASE + lenid, 256 + roid * LZ_LENID_SIZE + lenid),
        np.where(kind == 1, WORD_SYMBOL, buf[start].astype(np.int64)),
    )
    sr_ctx = cctx_arr[start] | (after_literal << 8)
    sr_unlikely = pred_arr[start] & 0xFF
    return Items(start, kind, length, symbol, sr_ctx, sr_unlikely, after_literal,
                 robitlen, robits, eml, pred_len=pred_ok)


def census_ref(symbols: np.ndarray):
    """Chunk-0 symbol census -> (num_counted, ordered counted symbols, full
    init permutation), mirroring reference src/lz.rs:238-265."""
    counts = np.bincount(symbols, minlength=SYMRANK_NUM_SYMBOLS)
    order = sorted(range(SYMRANK_NUM_SYMBOLS), key=lambda s: -max(int(counts[s]), 1))
    num_counted = int((counts > 1).sum())
    return num_counted, order[:num_counted], np.asarray(order, dtype=np.int64)


def symrank_ref(items: Items, init_perm: np.ndarray) -> np.ndarray:
    """Sequential symrank transform over all items (oracle for ops/symrank)."""
    sr = SymRankState(n_symbols=SYMRANK_NUM_SYMBOLS)
    sr.init_all(init_perm)
    coded = np.empty(len(items.start), dtype=np.int64)
    for i in range(len(items.start)):
        coded[i] = sr.encode(int(items.sr_ctx[i]), int(items.symbol[i]), int(items.sr_unlikely[i]))
    items.coded = coded
    return coded


def encode_segment_ref(data: bytes, level: int = 1,
                       chunk_input: int = CHUNK_INPUT_DEFAULT,
                       rings_mode: int | None = None) -> bytes:
    """Sequential OTZ encoder (slow; the stream-level oracle).

    rings_mode None picks the level default (spec.otz2_enabled); 1 runs the
    OTZ2 item-start-ring path: a masked re-analysis over the base parse's
    item starts, then demotion repair (spec.py OTZ2 block).  The iteration
    shift depths follow spec.otz2_schedule(), with deep shifts gated to
    mask queries past OTZ2_NEAR — mirroring the device pipeline."""
    from orz_tpu_torch.spec import OTZ2_NEAR, otz2_enabled, otz2_schedule

    if rings_mode is None:
        rings_mode = int(otz2_enabled(level))
    enc = BitEncoder()
    enc.encode_varint(len(data))
    enc.encode_varint(chunk_input)
    if not data:
        return enc.finish()

    buf = pad_segment(data)
    an = analyze_ref(buf, len(data), candidate_depth(level))
    items = None
    words_mode = 0
    if rings_mode:
        walk = parse_walk(an, buf, len(data))
        schedule = otz2_schedule(level)
        hist = []  # recent walks, newest last (pipeline keeps 3 candidates)
        for shifts in schedule:
            hist = hist[-2:] + [walk]
            mask = np.zeros(len(buf), dtype=bool)
            mask[walk[0]] = True
            an2 = analyze_ref(
                buf, len(data), shifts, start_mask=mask, words_mode=1,
                near_depth=OTZ2_NEAR if shifts > OTZ2_NEAR else 0)
            walk = parse_walk(an2, buf, len(data))

        def emit_at(w):
            """Conform analysis at w's own starts, then repair/emit; the
            demotion count (repair only ADDS items) ranks candidates —
            mirrors pipeline.dispatch_segment_mid2's best-of-2."""
            mask = np.zeros(len(buf), dtype=bool)
            mask[w[0]] = True
            from orz_tpu_torch.spec import (OTZ2_CONFORM_CAP,
                                             OTZ2_CONFORM_SHIFTS)

            c_shifts = OTZ2_CONFORM_SHIFTS or schedule[-1]
            an_c = analyze_ref(
                buf, len(data), c_shifts, start_mask=mask, words_mode=1,
                near_depth=OTZ2_NEAR if c_shifts > OTZ2_NEAR else 0,
                ro_cap=OTZ2_CONFORM_CAP)
            it = parse_ref(an_c, buf, len(data), rings_mode=1, walk=w,
                           words_mode=1)
            return it, (len(it.start) - len(w[0]) if it is not None else -1)

        cand = [emit_at(walk)]
        thr = max(1024, len(walk[0]) >> 7)  # pipeline's anomaly threshold
        for older in reversed(hist):
            if cand[-1][0] is not None and cand[-1][1] <= thr:
                break
            cand.append(emit_at(older))
        cand = [c for c in cand if c[0] is not None]
        items = min(cand, key=lambda c: c[1])[0] if cand else None
        if items is None:  # repair did not converge: OTZ1 fallback
            rings_mode = 0
        else:
            words_mode = 1
    if items is None:
        items = parse_ref(an, buf, len(data))
    return _finish_segment_stream(enc, items, len(data), chunk_input,
                                  rings_mode, words_mode=words_mode)


def _finish_segment_stream(enc: BitEncoder, items: Items, raw_len: int,
                           chunk_input: int, rings_mode: int,
                           words_mode: int = 0) -> bytes:
    """Header bits + census + symrank + per-chunk entropy coding (shared by
    every sequential encoder variant)."""
    enc.encode_raw_bits(int(items.pred_len), 1)  # length-prediction flag
    enc.encode_raw_bits(rings_mode, 1)  # ring insertion rule (spec.py OTZ2)
    enc.encode_raw_bits(words_mode, 1)  # word-table update rule (see header)

    n_chunks = n_chunks_for(raw_len, chunk_input)
    chunk_id = (items.start - PAD_FRONT) // chunk_input
    first_chunk = items.symbol[chunk_id == 0]
    num_counted, counted, init_perm = census_ref(first_chunk)
    enc.encode_varint(num_counted)
    for s in counted:
        enc.encode_raw_bits(int(s), 9)

    coded = symrank_ref(items, init_perm)

    for k in range(n_chunks):
        sel = chunk_id == k
        enc.encode_varint(int(sel.sum()))
        _encode_chunk_items(enc, items, coded, sel)
    return enc.finish()


def encode_segment_seq2(data: bytes, level: int = 2,
                        chunk_input: int = CHUNK_INPUT_DEFAULT,
                        depth: int | None = None,
                        lazy_depths: tuple | None = None,
                        fence: bool = True,
                        ro_cap: int = OTZ2_RO_CAP,
                        lcp0: int = 16,
                        rep0_search: bool = False,
                        rep0_margin: int = 2,
                        words_mode: int = 0) -> bytes:
    """Sequential OTZ2 encoder: TRUE item-start rings, built exactly the way
    the decoder replays them (insert each item's start after its own
    lookup), so the stream is rings_mode=1-decodable by construction — no
    conform/repair.  This mirrors the reference's sequential economics
    (src/matcher.rs:62-80 item-start ring insertion; src/lz.rs:131-235 parse
    loop with shallower lazy search depths) inside the OTZ format, and is
    the oracle/measurement harness for the parallel fixed-point pipeline.

    Knobs (measurement only; the format does not record them):
      depth        chain-walk candidates per position (reference l2: 45)
      lazy_depths  (d1, d2) for the lazy probes at p+1/p+2 (reference: 27/18)
      fence        apply the 512-byte parse fence cap (device pipeline: yes)
      ro_cap       candidate reduced-offset search cap (reference ring: 4094)
    """
    from orz_tpu_torch.spec import LAZY_LEN_CAP, ROBITS_CHEAP

    if depth is None:
        depth = candidate_depth(level)
    d1, d2 = lazy_depths if lazy_depths is not None else (depth, depth)

    enc = BitEncoder()
    enc.encode_varint(len(data))
    enc.encode_varint(chunk_input)
    if not data:
        return enc.finish()

    buf = pad_segment(data)
    n = len(buf)
    end = PAD_FRONT + len(data)
    cctx = cctx_all(buf)
    h2 = h2_all(buf)
    mkey = match_key_all(buf)

    words = np.zeros(WORD_TABLE_SIZE, dtype=np.int64)
    pred = np.zeros(n, dtype=np.int64)  # filled at item starts (for census)
    chains: dict = {}  # mkey -> list of item-start positions
    rank_of = np.zeros(n, dtype=np.int64)  # item-start rank at insertion
    ctx_count = np.zeros(NUM_CONTEXTS, dtype=np.int64)

    def find_best(p, cap):
        """Best item-start candidate at p: (len, ro, q) or (0, 0, -1)."""
        chain = chains.get(mkey[p])
        if not chain:
            return 0, 0, -1
        my_count = ctx_count[cctx[p]]
        best32, bro, blen, bq = 0, -1, 0, -1
        for q in chain[-1 : -depth - 1 : -1]:
            ro = my_count - 1 - rank_of[q]
            if ro >= ro_cap:
                break  # ranks only grow down the chain
            l32 = min(_lcp(buf, q, p, lcp0), cap)
            if l32 < min_match_len_for_ro(ro):
                continue
            if l32 > best32:
                best32, bro, bq = l32, ro, q
                blen = min(_lcp(buf, q, p, LZ_MATCH_MAX_LEN), cap) \
                    if l32 >= lcp0 else l32
        if bq < 0 or blen < LZ_MATCH_MIN_LEN:
            return 0, 0, -1
        return blen, bro, bq

    def has_lazy(p, want_len, d):
        """Any item-start candidate at p with lcp >= want_len (reference
        has_lazy_match, src/matcher.rs:194-228) under the price gate."""
        if p >= end or want_len > min(
            FENCE - ((p - PAD_FRONT) % FENCE) if fence else 1 << 30, end - p
        ):
            return False
        chain = chains.get(mkey[p])
        if not chain:
            return False
        my_count = ctx_count[cctx[p]]
        for q in chain[-1 : -d - 1 : -1]:
            ro = my_count - 1 - rank_of[q]
            if ro >= ro_cap:
                break
            if _lcp(buf, q, p, want_len) >= max(want_len,
                                                min_match_len_for_ro(ro)):
                return True
        return False

    starts, kinds, lengths, qs, ros = [], [], [], [], []
    p = PAD_FRONT
    done_word = PAD_FRONT
    last_dist = 0
    while p < end:
        if not words_mode:  # bytes-only rule: every position updates
            while done_word <= p - 3:
                u = done_word
                words[h2[u]] = int(buf[u + 1]) | int(buf[u + 2]) << 8
                done_word += 1
        pred[p] = words[h2[p - 1]]
        wordmatch = (int(buf[p]) | int(buf[p + 1]) << 8) == pred[p]

        cap = min(FENCE - ((p - PAD_FRONT) % FENCE) if fence else 1 << 30,
                  end - p)
        blen, ro, q = find_best(p, cap)
        # rep0-first (rep0_search knob): a match at the previous distance
        # costs a bare symbol (no offset bits) and is exempt from the ring
        # constraint, so prefer it unless the chain match is clearly longer
        if rep0_search and last_dist > 0 and p - last_dist >= PAD_FRONT:
            lr = min(_lcp(buf, p - last_dist, p, LZ_MATCH_MAX_LEN), cap)
            if lr >= LZ_MATCH_MIN_LEN and lr + rep0_margin >= blen:
                blen, ro, q = lr, 0, p - last_dist
        is_m = blen >= LZ_MATCH_MIN_LEN
        lazy1 = False
        if is_m and blen < LAZY_LEN_CAP:
            robitlen = int(ROID_ENC[ro, 1])
            lazy_len1 = blen + 1 + (1 if robitlen < ROBITS_CHEAP else 0)
            lazy1 = has_lazy(p + 1, lazy_len1, d1)
            lazy2 = has_lazy(p + 2, lazy_len1 - int(wordmatch), d2)
            if lazy1 or lazy2:
                is_m = False
        if is_m:
            starts.append(p); kinds.append(2); lengths.append(blen)
            qs.append(q); ros.append(ro)
            last_dist = p - q
            adv = blen
        elif (wordmatch and not lazy1 and p + 2 <= end
              and (not fence or FENCE - ((p - PAD_FRONT) % FENCE) >= 2)):
            starts.append(p); kinds.append(1); lengths.append(2)
            qs.append(0); ros.append(0)
            adv = 2
        else:
            starts.append(p); kinds.append(0); lengths.append(1)
            qs.append(0); ros.append(0)
            adv = 1

        # ring insertion: the item's start, after its own lookup (exactly
        # the decoder's order, decode_segment_ref rings_mode=1)
        c = cctx[p]
        rank_of[p] = ctx_count[c]
        ctx_count[c] += 1
        chains.setdefault(mkey[p], []).append(p)
        p += adv
        if words_mode and adv != 2:
            # words_mode=1 (the reference's rule, src/lz.rs:203,233): the
            # table is sampled ONLY at item ends (after literal and match
            # items, not word items), keying 3 back from the new position.
            # Hot keys stop churning mid-match; measured ~7x more word hits.
            words[h2[p - 3]] = int(buf[p - 2]) | int(buf[p - 1]) << 8

    start = np.asarray(starts, dtype=np.int64)
    kind = np.asarray(kinds, dtype=np.int64)
    length = np.asarray(lengths, dtype=np.int64)
    q_arr = np.asarray(qs, dtype=np.int64)
    ro_arr = np.asarray(ros, dtype=np.int64)
    _, _, rep0 = _rep0_flags(start, kind, q_arr)
    items = _emit_items(cctx, pred, buf, len(data), start, kind, length,
                        q_arr, ro_arr, rep0)
    return _finish_segment_stream(enc, items, len(data), chunk_input, 1,
                                  words_mode)


def _encode_chunk_items(enc: BitEncoder, items: Items, coded: np.ndarray, sel: np.ndarray) -> None:
    cs = coded[sel]
    al = items.after_literal[sel]
    kind = items.kind[sel]
    eml = items.eml[sel]
    robitlen = items.robitlen[sel]
    robits = items.robits[sel]

    wA = np.bincount(cs[al == 1], minlength=SYMRANK_NUM_SYMBOLS)
    wB = np.bincount(cs[al == 0], minlength=SYMRANK_NUM_SYMBOLS)
    wC = np.bincount(
        eml[(kind == 2) & (eml >= LZ_LENID_SIZE - 1)], minlength=TABC_SIZE
    )
    lensA = pm_code_lens(wA)
    lensB = pm_code_lens(wB)
    lensC = pm_code_lens(wC)
    for lens in (lensA, lensB, lensC):
        enc.encode_huffman_table(list(lens))
    encA = canonical_encodings(list(lensA))
    encB = canonical_encodings(list(lensB))
    encC = canonical_encodings(list(lensC))

    for i in range(len(cs)):
        enc.encode_huffman_sym(encA if al[i] else encB, int(cs[i]))
        if kind[i] == 2:
            enc.encode_raw_bits(int(robits[i]), int(robitlen[i]))
            if eml[i] >= LZ_LENID_SIZE - 1:
                enc.encode_huffman_sym(encC, int(eml[i]))


class OTZFormatError(Exception):
    pass


def decode_segment_ref(payload: bytes) -> bytes:
    """Sequential OTZ decoder."""
    dec = BitDecoder(payload)
    raw_len = dec.decode_varint()
    chunk_input = dec.decode_varint()
    if raw_len == 0:
        return b""
    if raw_len > (1 << 31):
        raise OTZFormatError("implausible segment length")
    if chunk_input <= 0 or chunk_input > (1 << 31):
        raise OTZFormatError("bad chunk_input")

    buf = np.zeros(PAD_FRONT + raw_len + PAD_TAIL, dtype=np.uint8)
    end = PAD_FRONT + raw_len
    pred_len = dec.decode_raw_bits(1)
    rings_mode = dec.decode_raw_bits(1)  # 1: item-start rings (spec.py OTZ2)
    words_mode = dec.decode_raw_bits(1)  # 1: word table sampled at item ends

    num_counted = dec.decode_varint()
    if num_counted > SYMRANK_NUM_SYMBOLS:
        raise OTZFormatError("bad census")
    seen = np.zeros(SYMRANK_NUM_SYMBOLS, dtype=bool)
    perm: List[int] = []
    for _ in range(num_counted):
        s = dec.decode_raw_bits(9)
        if s >= SYMRANK_NUM_SYMBOLS or seen[s]:
            raise OTZFormatError("bad census symbol")
        perm.append(s)
        seen[s] = True
    perm.extend(s for s in range(SYMRANK_NUM_SYMBOLS) if not seen[s])

    sr = SymRankState(n_symbols=SYMRANK_NUM_SYMBOLS)
    sr.init_all(np.asarray(perm, dtype=np.int64))
    words = np.zeros(WORD_TABLE_SIZE, dtype=np.int64)
    ring = np.zeros((NUM_CONTEXTS, RING), dtype=np.int64)
    ctx_count = np.zeros(NUM_CONTEXTS, dtype=np.int64)
    expected_arr = np.zeros(len(buf), dtype=np.int64)
    len_min_arr = np.zeros(len(buf), dtype=np.int64)

    _ALNUM = np.zeros(256, dtype=np.int64)
    for b in range(256):
        _ALNUM[b] = int(chr(b).isascii() and chr(b).isalnum())

    def cctx_at(p: int) -> int:
        return (int(buf[p - 1]) & 0x7F) | (int(_ALNUM[buf[p - 2]]) << 7)

    def h2_at(x: int) -> int:
        return (int(buf[x]) & 0x7F) | (cctx_at(x) << 7)

    p = PAD_FRONT
    done_ring = PAD_FRONT  # next position to insert into its context ring
    done_word = PAD_FRONT  # next word-model update u to apply
    after_literal = True
    last_dist = 0  # rep0 state: distance of the most recent match

    n_chunks = n_chunks_for(raw_len, chunk_input)
    for _ in range(n_chunks):
        n_items = dec.decode_varint()
        tabs = []
        for nsym in (SYMRANK_NUM_SYMBOLS, SYMRANK_NUM_SYMBOLS, TABC_SIZE):
            code_lens, max_len = dec.decode_huffman_table()
            if len(code_lens) > nsym:
                raise OTZFormatError("oversized huffman table")
            # a corrupt stream could claim a huge max_len and the LUT below
            # allocates 1 << max_len entries; the format never exceeds 15
            # (mirrors csrc/otz_core.cpp HuffDec::build)
            if max_len > HUFFMAN_MAX_CODE_LEN:
                raise OTZFormatError("huffman code length over limit")
            tabs.append(HuffmanDecoding(code_lens, max_len))
        tabA, tabB, tabC = tabs

        for _ in range(n_items):
            if p >= end:
                raise OTZFormatError("items past end")
            # catch up bytes-only model state; word updates for u <= p-3
            # become visible.  rings_mode=0: every position q < p enters its
            # context ring; rings_mode=1: only item starts do (inserted at
            # the bottom of this loop, after the item's own ring lookup).
            while not rings_mode and done_ring < p:
                c = cctx_at(done_ring)
                ring[c, ctx_count[c] % RING] = done_ring
                ctx_count[c] += 1
                done_ring += 1
            while not words_mode and done_word <= p - 3:
                u = done_word
                words[h2_at(u)] = int(buf[u + 1]) | int(buf[u + 2]) << 8
                done_word += 1

            p0 = p  # item start (ring-inserted below when rings_mode=1)
            c1 = cctx_at(p)
            last_word = int(words[h2_at(p - 1)])
            sr_ctx = c1 | (int(after_literal) << 8)
            sym = dec.decode_huffman_sym(tabA if after_literal else tabB)
            if sym >= SYMRANK_NUM_SYMBOLS:
                raise OTZFormatError("symbol out of range")
            v = sr.decode(sr_ctx, sym, last_word & 0xFF)

            if v == WORD_SYMBOL:
                if p + 2 > end:
                    raise OTZFormatError("word past end")
                buf[p] = last_word & 0xFF
                buf[p + 1] = last_word >> 8
                p += 2
                after_literal = False
            elif v <= 255:
                buf[p] = v
                p += 1
                after_literal = True
            else:
                if v >= REP0_BASE:  # rep0: previous match's distance
                    lenid = v - REP0_BASE
                    if last_dist <= 0:
                        raise OTZFormatError("rep0 with no previous match")
                    q = p - last_dist
                else:
                    roid = (v - 256) // LZ_LENID_SIZE
                    lenid = (v - 256) % LZ_LENID_SIZE
                    robase, robitlen = int(ROID_DEC[roid, 0]), int(ROID_DEC[roid, 1])
                    ro = robase + dec.decode_raw_bits(robitlen)
                    if ro >= ctx_count[c1]:
                        raise OTZFormatError("reduced offset out of range")
                    q = int(ring[c1, (ctx_count[c1] - 1 - ro) % RING])
                if lenid == LZ_LENID_SIZE - 1:
                    eml = dec.decode_huffman_sym(tabC)
                else:
                    eml = lenid
                if q >= p or q < PAD_FRONT:
                    raise OTZFormatError("bad match target")
                if pred_len:
                    room = min(FENCE - ((p - PAD_FRONT) % FENCE), end - p)
                    lm = min(max(int(len_min_arr[q]), LZ_MATCH_MIN_LEN), room)
                    ex = max(int(expected_arr[q]), LZ_MATCH_MIN_LEN)
                    if eml >= NEG_EML_BASE:  # negative band: below len_min
                        match_len = lm - 1 - (eml - NEG_EML_BASE)
                    elif eml + lm > ex:
                        match_len = eml + lm
                    elif eml > 0:
                        match_len = eml + lm - 1
                    else:
                        match_len = ex
                    if len_min_arr[q] <= match_len:
                        len_min_arr[q] = min(match_len + 1, 127)
                    expected_arr[p] = match_len
                else:
                    match_len = eml + LZ_MATCH_MIN_LEN
                if match_len < LZ_MATCH_MIN_LEN or p + match_len > end:
                    raise OTZFormatError("bad match span")
                for k in range(match_len):
                    buf[p + k] = buf[q + k]
                last_dist = p - q
                p += match_len
                after_literal = False

            if rings_mode:  # item-start ring insertion (after own lookup)
                ring[c1, ctx_count[c1] % RING] = p0
                ctx_count[c1] += 1
            if words_mode and p - p0 != 2:
                # word table sampled at item ends only (not after word
                # items) — the reference's rule, src/lz.rs:203,233
                words[h2_at(p - 3)] = int(buf[p - 2]) | int(buf[p - 1]) << 8

    if p != end:
        raise OTZFormatError("decoded length mismatch")
    return buf[PAD_FRONT:end].tobytes()
