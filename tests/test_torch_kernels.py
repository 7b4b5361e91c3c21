"""Each kernel module of the torch port against its JAX counterpart.

On the CPU every kernel wrapper runs its plain torch version; these tests
hold those plain versions to the JAX package at B=2, cap=1<<15, on arrays
from a real FRONT: K1 and K2 (masked, on the FRONT parse's mask and the
port's own plan) against ``match_depth_pallas`` (interpret mode; K1's
outputs recorded in ``tests/torch_jax_records.json``, record
``match-depth``, by ``tests/torch_parity_ref.py``), K3 and
K4 against ``walk_items_b`` / ``walk_mask_pallas`` (what the JAX package
runs off the TPU) and against the Pallas walk kernels themselves
(interpret mode, on stress rows), K5 against ``symrank_pallas_b``
(interpret mode) and the sequential oracle; the segmented scans' plain
versions against a Python loop over groups.  All outputs are integers:
tolerance 0.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from orz_tpu_torch.device.host import N_DW, S, _bucket, pad_batch
from orz_tpu_torch.kernels import (
    fence_walk,
    match_depth,
    match_depth_masked,
    seg_scan,
    symrank,
    walk_mask,
)
from orz_tpu_torch.ops import batched as ob
from orz_tpu_torch.ops import otz2
from orz_tpu_torch.spec import (
    FAR_RO_1,
    FAR_RO_2,
    FENCE,
    LZ_MATCH_MIN_LEN,
    OTZ2_RO_CAP,
    PAD_FRONT,
    RING,
    _FAR_GATE,
)
from tests.conftest import make_binary_like, make_text_like
from tests.torch_parity_ref import digest, expect
from torch_walk_inputs import (
    SEG_SCAN_CASES,
    WALK_KINDS,
    WALK_VARIANTS,
    fence_walk_inputs,
    seg_scan_inputs,
    seg_scan_ref,
    seg_scan_values,
    walk_inputs,
    walk_plain,
)

torch.set_num_threads(2)

CAP = 1 << 15


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0x70C4)
    segs = [make_text_like(rng, 30000), make_binary_like(rng, 30000)]
    bufs, lens = pad_batch(segs, CAP)
    return torch.from_numpy(bufs), torch.from_numpy(lens)


@pytest.fixture(scope="module")
def candidates(batch):
    bufs, lens = batch
    n = bufs.shape[1]
    p = torch.arange(n)
    valid = (p >= PAD_FRONT) & (p < (PAD_FRONT + lens).view(-1, 1))
    ba = ob.byte_arrays_b(bufs)
    rank = ob.context_ranks_b(ba, valid)
    msk, msp, rank_s, dw_s = ob.candidate_arrays_b(ba, rank, valid)
    return msk, msp, rank_s, dw_s, (PAD_FRONT + lens).int()


@pytest.fixture(scope="module")
def items(batch):
    bufs, lens = batch
    st, ni, pk1, bq, bro, bufs, _ = ob.front_body_b(bufs, lens, 8)
    it, r1, rounds = ob.mid_body_b(st, ni, pk1, bq, bro, bufs, lens,
                                   _bucket(int(ni.max()), 1 << 14, 2))
    _, _, order, _ = ob.census_b(it, 1 << 21, 1)
    return it, order, r1, rounds


@pytest.mark.parametrize("depth", [4, 8, 32])
def test_match_depth_plain_matches_pallas(candidates, depth):
    msk, msp, rank_s, dw_s, end = candidates
    rows = expect("match-depth", list(candidates))["depths"][str(depth)]
    got = match_depth.match_depth(msk, msp, rank_s, dw_s, end, depth)
    assert int((got[0] >= 0).sum()) > 1000  # real candidates were found
    assert len(rows) == msk.shape[0]
    for b, want in enumerate(rows):
        for g, w in zip(got, want):
            assert digest(g[b]) == w


def _masked_candidates(bufs, lens, mask):
    """K2's inputs as a QUALITY step builds them: the port's plan, and the
    masked ranks and the mask in the plan's candidate order."""
    n = bufs.shape[1]
    p = torch.arange(n)
    valid = (p >= PAD_FRONT) & (p < (PAD_FRONT + lens).view(-1, 1))
    if mask is None:  # a literal-only parse: every position starts an item
        mask = valid
    plan = ob.masked_plan_b(bufs, lens)
    rank = ob.masked_context_counts_planned_b(plan, valid, mask)
    order = plan.msp.long()
    return (plan.msk, plan.msp, torch.gather(rank, 1, order), plan.dw_s,
            (PAD_FRONT + lens).int(), torch.gather(mask, 1, order))


@pytest.fixture(scope="module")
def masked_candidates(batch):
    """Iteration: the binary-like row (long same-key runs) with the FRONT
    parse's mask.  Conform: a row whose 3000-byte block (random bytes,
    each after an 'a') comes back after 5000 more 'a's, with every
    position a candidate, so the block's offsets (counted among the
    positions of the same context) pass the near cap."""
    bufs, lens = batch
    mask = ob.front_body_b(bufs[1:], lens[1:], 8)[6]
    block = np.full(3000, ord("a"), np.uint8)
    block[1::2] = np.random.default_rng(7).integers(0, 256, 1500)
    block = block.tobytes()
    far = (torch.from_numpy(a)
           for a in pad_batch([block + b"a" * 5000 + block], CAP))
    return {"iteration": _masked_candidates(bufs[1:], lens[1:], mask),
            "conform": _masked_candidates(*far, None)}


@pytest.mark.parametrize("variant", ["iteration", "conform"])
def test_match_depth_masked_plain_matches_pallas(masked_candidates, variant):
    """Depth 160 (past one 128-shift band) with near gating at 96, one
    row each: the iteration cap, and the conform's two-tier cap with
    matches in both tiers."""
    from orz_tpu.ops.match_pallas import match_depth_pallas

    args = masked_candidates[variant]
    msk, msp, rank_s, dw_s, end, mask_s = args
    ro_cap, near_cap = {"iteration": (OTZ2_RO_CAP, None),
                        "conform": (RING, OTZ2_RO_CAP)}[variant]
    got = match_depth_masked.match_depth_masked(*args, 160, ro_cap, 96,
                                                near_cap)
    assert int((got[0] >= 0).sum()) > 500
    if near_cap is not None:  # both tiers took matches
        assert int((got[1] >= near_cap).sum()) > 100
        assert int(((got[0] >= 0) & (got[1] < near_cap)).sum()) > 100
    want = match_depth_pallas(
        jnp.asarray(msk[0].numpy()), jnp.asarray(msp[0].numpy()),
        jnp.asarray(rank_s[0].numpy()),
        tuple(jnp.asarray(dw_s[0, t].numpy()) for t in range(N_DW)),
        jnp.int32(int(end[0])), depth=160,
        mask_s=jnp.asarray(mask_s[0].numpy()), ro_cap=ro_cap,
        near_depth=96, ro_cap_near=near_cap,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_walk_mask_plain_matches_walk_mask_pallas(batch):
    from orz_tpu.ops.walk_pallas import walk_mask_pallas

    bufs, lens = batch
    n = bufs.shape[1]
    nxt = ob.decisions_b(ob.analyze_b(bufs, lens, 8), lens, n).nxt
    mask, n_items = walk_mask.walk_mask(nxt, lens)
    j_mask, j_ni = jax.jit(walk_mask_pallas, static_argnums=2)(
        jnp.asarray(nxt.numpy()), jnp.asarray(lens.numpy()), n)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(n_items.numpy(), np.asarray(j_ni))
    assert n_items.dtype == torch.int32 and int(n_items.min()) > 1000


def test_fence_walk_plain_matches_walk_items_b(batch):
    from orz_tpu.ops.batched import mask_from_starts_b, walk_items_b

    bufs, lens = batch
    n = bufs.shape[1]
    nxt = ob.decisions_b(ob.analyze_b(bufs, lens, 8), lens, n).nxt
    starts, n_items, mask = fence_walk.walk_items(nxt, lens)

    j_nxt, j_lens = jnp.asarray(nxt.numpy()), jnp.asarray(lens.numpy())
    j_starts, j_ni = jax.jit(walk_items_b, static_argnums=2)(j_nxt, j_lens, n)
    j_mask = mask_from_starts_b(j_starts, j_ni, n)
    np.testing.assert_array_equal(n_items.numpy(), np.asarray(j_ni))
    np.testing.assert_array_equal(starts.numpy(), np.asarray(j_starts))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    assert int(n_items.min()) > 1000


def _pallas_walk(nxt, lens):
    """``walk_pallas``'s REC and MASK kernels in interpret mode, built as
    ``tests/test_walk_pallas.py`` builds them: the (B, n) bool mask and the
    per-segment starts sorted, the REC kernel's sentinel last."""
    from orz_tpu.ops import walk_pallas as W

    bsz, n = nxt.shape
    localT, blk_endT, base, _, n_blocks, nb_total, cells = W._prep(
        jnp.asarray(nxt.numpy()), jnp.asarray(lens.numpy()), n)
    rec = W._call(W._rec_kernel, localT, blk_endT, cells).T[:nb_total]
    starts = jnp.sort(jnp.where(
        rec >= W.SENT, jnp.int32(0x7FFFFFFE), rec + base[:, None]
    ).reshape(bsz, n_blocks * FENCE), axis=-1)
    mk = W._call(W._mask_kernel, localT, blk_endT, cells).T[:nb_total]
    width = min(n - PAD_FRONT, n_blocks * FENCE)
    mask = np.zeros((bsz, n), bool)
    mask[:, PAD_FRONT:PAD_FRONT + width] = np.asarray(
        mk.reshape(bsz, n_blocks * FENCE)[:, :width]) != 0
    return mask, np.asarray(starts)


def test_walk_plain_matches_pallas_kernels():
    """K3's and K4's plain walks (``fence_walk_mask_plain``, ``walk_items``,
    ``walk_mask_plain``) against the Pallas REC and MASK kernels run in
    interpret mode, on two segments of unequal length that both end
    inside a block, n - PAD_FRONT not a multiple of FENCE, and one block
    of each kind of ``fence_walk_inputs``: block 0 of row 0 is FENCE
    length-1 items (the longest chain), row 1's blocks jump past their end
    and to chunk edges."""
    n = PAD_FRONT + 2 * FENCE + 1000
    nxt, lens = fence_walk_inputs(7, n, [2 * FENCE + 900, FENCE + 1234],
                                  first=[0, 3])
    mask, starts = _pallas_walk(nxt, lens)
    np.testing.assert_array_equal(
        fence_walk.fence_walk_mask_plain(nxt, lens).numpy(), mask)
    k4_mask, k4_items = walk_mask.walk_mask_plain(nxt, lens)
    np.testing.assert_array_equal(k4_mask.numpy(), mask)
    np.testing.assert_array_equal(k4_items.numpy(), mask.sum(axis=1))
    k3_starts, k3_items, k3_mask = fence_walk.walk_items(nxt, lens)
    np.testing.assert_array_equal(k3_mask.numpy(), mask)
    end = (PAD_FRONT + lens).numpy()
    n_items = (starts < end[:, None]).sum(axis=1)
    np.testing.assert_array_equal(k3_items.numpy(), n_items)
    for b in range(2):
        np.testing.assert_array_equal(k3_starts[b, :n_items[b]].numpy(),
                                      starts[b, :n_items[b]])
        assert (k3_starts[b, n_items[b]:] == int(end[b])).all()
    assert mask[0, PAD_FRONT:PAD_FRONT + FENCE].all()
    assert mask[1, PAD_FRONT + FENCE + 1234:].sum() == 0


def _chunked_walk(jump, blk_end: int):
    """The walk of ``csrc/fence_walk.cu`` in Python, for one block's local
    jumps: lane l walks its chunk [128 l, 128 l + 128) speculatively from
    the chunk's first position; then, in lane order, each chunk is fixed
    up from its true entry (the previous chunk's true exit): no starts if
    the entry lies past the chunk, the speculation if it is the chunk's
    first position, else a walk from the entry until it meets a
    speculative mark (the merge point m) or leaves the chunk; the chunk's
    marks are the fix-up marks below m and the speculative ones from m on.
    Returns the marks and the fix-up steps."""
    chunk = FENCE // 32
    spec = np.zeros(FENCE, bool)
    fix = np.zeros(FENCE, bool)
    exits = []
    for lane in range(32):
        cur, c_end = lane * chunk, min(lane * chunk + chunk, blk_end)
        while cur < c_end:
            spec[cur] = True
            cur = max(int(jump[cur]), cur + 1)
        exits.append(cur)
    marks = np.zeros(FENCE, bool)
    entry = steps = 0
    for lane in range(32):
        c0 = lane * chunk
        c_end, m = min(c0 + chunk, blk_end), c0
        if entry >= c_end:
            m, out = c0 + chunk, entry
        elif entry == c0:
            out = exits[lane]
        else:
            cur = entry
            while cur < c_end and not spec[cur]:
                fix[cur] = True
                cur = max(int(jump[cur]), cur + 1)
                steps += 1
            m, out = (cur, exits[lane]) if cur < c_end else (c0 + chunk, cur)
        at = np.arange(c0, c0 + chunk)
        marks[at] = np.where(at < m, fix[at], spec[at])
        entry = out
    return marks, steps


def test_walk_chunk_model_matches_plain():
    """The chunked speculative walk (``_chunked_walk``) equals the plain
    walk on every block of the stress rows, the longest chain, jumps past
    the block, segment ends inside a block, an empty segment and 'thirds'
    blocks included, whose fix-ups never merge."""
    n = PAD_FRONT + 12 * FENCE + 333
    nxt, lens = fence_walk_inputs(11, n, [12 * FENCE + 333,
                                          7 * FENCE + 2000, 0])
    want = fence_walk.fence_walk_mask_plain(nxt, lens).numpy()
    steps = dict.fromkeys(WALK_KINDS, 0)
    for b in range(3):
        for base in range(PAD_FRONT, n, FENCE):
            width = min(FENCE, n - base)
            jump = np.ones(FENCE, np.int64)
            jump[:width] = np.clip(nxt[b, base:base + width].numpy()
                                   .astype(np.int64) - base, 1, FENCE)
            blk_end = int(np.clip(PAD_FRONT + int(lens[b]) - base, 0, width))
            marks, k = _chunked_walk(jump, blk_end)
            np.testing.assert_array_equal(marks[:width],
                                          want[b, base:base + width])
            kind = WALK_KINDS[(b + (base - PAD_FRONT) // FENCE) % 6]
            steps[kind] = max(steps[kind], k)
    assert steps["thirds"] > 800  # fix-ups over whole chunks
    assert steps["literals"] == 0  # every chunk start is on the path


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_walk_rejects_bad_input(bad):
    nxt, lens = fence_walk_inputs(1, PAD_FRONT + FENCE, [100])
    if bad == "dtype":
        nxt = nxt.long()
    else:
        lens = lens.repeat(2)
    for fn in (fence_walk.fence_walk_mask, fence_walk.walk_items,
               walk_mask.walk_mask):
        with pytest.raises(ValueError):
            fn(nxt, lens)


def test_symrank_plain_matches_pallas_and_oracle(items):
    from orz_tpu.device.refcodec import symrank_ref
    from orz_tpu.ops.batched import symrank_pallas_b
    from orz_tpu.ops.symrank_pallas import RB_BLK

    it, order, r1, rounds = items
    coded = symrank.symrank(it.symbol, it.sr_unlikely, it.sr_ctx, it.n_items,
                            order)
    r1_cap = _bucket(max(int(r1.max()), 1), RB_BLK)
    rm_cap = _bucket(max(int((rounds - r1).max()), 1), 4 * RB_BLK)
    want = jax.jit(symrank_pallas_b, static_argnames=("r1_cap", "rm_cap"))(
        *(jnp.asarray(t.numpy()) for t in
          (it.symbol, it.sr_unlikely, it.sr_ctx, it.n_items, order)),
        r1_cap=r1_cap, rm_cap=rm_cap,
    )
    for b in range(coded.shape[0]):
        ni = int(it.n_items[b])
        np.testing.assert_array_equal(coded[b, :ni].numpy(),
                                      np.asarray(want[b, :ni]))
        oracle = symrank_ref(
            SimpleNamespace(start=np.arange(ni),
                            sr_ctx=it.sr_ctx[b, :ni].numpy(),
                            symbol=it.symbol[b, :ni].numpy(),
                            sr_unlikely=it.sr_unlikely[b, :ni].numpy()),
            order[b].numpy(),
        )
        np.testing.assert_array_equal(coded[b, :ni].numpy(), oracle)
        assert not coded[b, ni:].any()


def test_huffman_rows_match_host_package_merge():
    from orz_tpu.device.pm_huffman import pm_code_lens
    from orz_tpu.golden.huffman import canonical_encodings
    from orz_tpu_torch.ops.huffman import canonical_codes_b, pm_code_lens_b

    rng = np.random.default_rng(0x4FF)
    rows = [np.zeros(431, np.int64), np.eye(1, 431, 7, dtype=np.int64)[0]]
    for k in (2, 20, 300, 431):  # sparse to dense, skewed weights
        w = np.zeros(431, np.int64)
        w[rng.choice(431, k, replace=False)] = rng.zipf(1.3, k) % (1 << 20)
        rows.append(w)
    w = np.stack(rows)
    lens = pm_code_lens_b(torch.from_numpy(w))
    codes = canonical_codes_b(lens)
    for r in range(w.shape[0]):
        want = np.asarray(pm_code_lens(w[r]))
        np.testing.assert_array_equal(lens[r].numpy(), want)
        enc = canonical_encodings(want.tolist())
        np.testing.assert_array_equal(codes[r].numpy(),
                                      [code for code, _ in enc])


@pytest.mark.parametrize("bad", ["dtype", "shape", "depth", "mask_align"])
def test_match_depth_rejects_bad_input(candidates, bad):
    """Bad dtypes, shapes and depths; and K2's mask_s at a storage offset
    that is not a multiple of 4 (the kernel stages it in 4-byte words)."""
    msk, msp, rank_s, dw_s, end = candidates
    depth = 8
    if bad == "mask_align":
        bsz, n = msk.shape
        mask_s = torch.ones(bsz * n + 1, dtype=torch.bool)[1:].view(bsz, n)
        assert mask_s.is_contiguous() and mask_s.data_ptr() % 4
        with pytest.raises(ValueError, match="aligned"):
            match_depth_masked.match_depth_masked(msk, msp, rank_s, dw_s,
                                                  end, mask_s, depth,
                                                  OTZ2_RO_CAP)
        return
    if bad == "dtype":
        msk = msk.long()
    elif bad == "shape":
        dw_s = dw_s[:, :4]
    else:
        depth = 1024
    with pytest.raises(ValueError):
        match_depth.match_depth(msk, msp, rank_s, dw_s, end, depth)


def _walk_model(args, depth: int, variant: str, tile: int):
    """K2's walk in ``csrc/match_depth.cu``, in Python: per tile of
    ``tile`` slots, the window's mask-1 slots compacted in slot order; each
    query walks them newest first within its jmax shifts, stops at the
    first other key, skips far candidates once the best score reaches
    min(64, cap), and stops at a near best whose LCP is min(64, cap).
    Returns the outputs and the number of such stops."""
    ro_cap, near, near_cap = WALK_VARIANTS[variant]
    near_cap = ro_cap if near_cap is None else min(near_cap, ro_cap)
    msk, msp, rank_s, dw_s, end, mask_s = (t.tolist() for t in args)
    dw_s = [list(zip(*row)) for row in dw_s]  # (B, n) tuples of N_DW
    need_min = min(LZ_MATCH_MIN_LEN, LZ_MATCH_MIN_LEN + _FAR_GATE,
                   LZ_MATCH_MIN_LEN + 2 * _FAR_GATE)
    bsz, n = len(msk), len(msk[0])
    out = [[[-1] * n for _ in range(bsz)], [[0] * n for _ in range(bsz)],
           [[0] * n for _ in range(bsz)]]
    stops = 0
    for b in range(bsz):
        key, pos, rank, dw = msk[b], msp[b], rank_s[b], dw_s[b]
        for t0 in range(0, n, tile):
            lo, hi = max(t0 - depth, 0), min(t0 + tile, n)
            cand = [c for c in range(lo, hi) if mask_s[b][c]]
            at = 0  # candidates before the query
            for i in range(t0, hi):
                while at < len(cand) and cand[at] < i:
                    at += 1
                p = pos[i]
                maxlcp = min(4 * N_DW, FENCE - ((p - PAD_FRONT) & (FENCE - 1)),
                             end[b] - p)
                jmax = min(depth, i)
                if near and not mask_s[b][i]:
                    jmax = min(jmax, near)
                bs, bc, bro, blen = 0, -1, 0, 0
                for c in (reversed(cand[:at]) if maxlcp >= need_min else ()):
                    if c < i - jmax or key[c] != key[i]:
                        break
                    ro = rank[i] - 1 - rank[c]
                    if ro >= ro_cap:
                        continue
                    far = ro >= near_cap
                    if far and bs >= maxlcp:
                        continue
                    need = LZ_MATCH_MIN_LEN + _FAR_GATE * (ro >= FAR_RO_1) \
                        + _FAR_GATE * (ro >= FAR_RO_2)
                    if maxlcp < need:
                        continue
                    lcp = maxlcp
                    for t in range((maxlcp + 3) // 4):
                        x = (dw[i][t] ^ dw[c][t]) & 0xFFFFFFFF
                        if x:
                            lcp = min(4 * t + ((x & -x).bit_length() - 1) // 8,
                                      maxlcp)
                            break
                    if lcp < need:
                        continue
                    score = lcp if far else lcp * 1024 + 1023 - (i - c)
                    if score > bs:
                        bs, bc, bro, blen = score, c, ro, lcp
                        if not far and lcp == maxlcp:
                            stops += 1
                            break
                out[0][b][i] = pos[bc] if bc >= 0 else -1
                out[1][b][i], out[2][b][i] = bro, blen
    return tuple(torch.tensor(o, dtype=torch.int32) for o in out), stops


@pytest.mark.parametrize("variant,mask", [("iteration", "random"),
                                          ("two_tier", "random"),
                                          ("iteration", "ones")])
def test_match_depth_walk_model_matches_plain(variant, mask):
    """K2's walk order (tiles of 1024 slots with a 384-slot halo, the
    compacted mask-1 list, the stop at the first other key, the exact stop
    at the cap) equals the plain version at depth 384 on rows of 2300
    slots (not a multiple of the tile): row 0 has a 1200-slot key group
    across a tile edge, longer than 384, row 1 small groups; with the
    random mask 70% of the queries carry mask 0 and stop at near_depth;
    LCPs tie and reach their caps; the two-tier variant takes matches in
    both tiers."""
    rng = np.random.default_rng(2)
    args = walk_inputs(4, 2300, [[5, 1, 1200, 30, 700, 2],
                                 list(rng.integers(1, 60, 60))], mask)
    (got, stops) = _walk_model(args, 384, variant, tile=1024)
    want = walk_plain(args, 384, variant)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert stops > 100 and int((got[0] >= 0).sum()) > 1000
    if variant == "two_tier":  # both tiers took matches
        near_cap = WALK_VARIANTS[variant][2]
        assert int((got[1] >= near_cap).sum()) > 20
        assert int(((got[0] >= 0) & (got[1] < near_cap)).sum()) > 100


def test_symrank_step_quotient_is_floor_division():
    """``csrc/symrank.cu`` step_quotient: (isum * m) >> 34 with m = 2^30 //
    cnt + 1 equals (isum >> 4) // cnt for every count 1..S+1 and every isum
    the transform reaches (it starts at 10^6 and gains at most S-1 an item
    for S+1 items before its first 9/10 decay).  Both sides are
    nondecreasing in isum and the product never falls below the true
    quotient, so the first and last isum of every quotient step cover
    every isum between them."""
    isum_max = 1000000 + (S + 1) * (S - 1)
    for cnt in range(1, S + 2):
        m = (1 << 30) // cnt + 1
        k = np.arange(isum_max // (16 * cnt) + 1, dtype=np.int64)
        x = np.concatenate([16 * cnt * k,
                            np.minimum(16 * cnt * (k + 1) - 1, isum_max)])
        np.testing.assert_array_equal((x * m) >> 34, (x >> 4) // cnt)


@pytest.mark.parametrize("bsz", [1, 4])
@pytest.mark.parametrize("case", SEG_SCAN_CASES)
def test_seg_scan_plain_matches_group_loop(case, bsz):
    """Both segmented scans (the wrappers, which run the plain versions on
    the CPU) against a Python loop over each row's groups, on rows of two
    kernel tiles and 5 slots; and ``_words1_scan_b``'s predecessor of the
    newest update against its earlier form, which clipped ``u1`` shifted
    by one at the group start."""
    first, marked = seg_scan_inputs(case, bsz, 2 * seg_scan.TILE + 5,
                                    seed=bsz)
    last, count = seg_scan_ref(first, marked)
    u1 = seg_scan.last_marked(first, marked)
    assert u1.dtype == torch.int32
    np.testing.assert_array_equal(u1.numpy(), last)
    got = seg_scan.exclusive_count(first, marked)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), count)
    prev = torch.cat([torch.full_like(u1[:, :1], -1), u1[:, :-1]], dim=1)
    old = torch.where(prev >= seg_scan._group_start(first), prev, -1)
    np.testing.assert_array_equal(ob._prev_in_group(first, u1).numpy(),
                                  old.numpy())


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("n", [seg_scan.TILE - 1, 2 * seg_scan.TILE + 5])
@pytest.mark.parametrize("case", SEG_SCAN_CASES)
def test_seg_scan_values_plain_matches_group_loop(case, n, grouped):
    """The running max and the exclusive sum (the wrappers, which run the
    plain versions on the CPU) against a Python loop over each row's
    groups, B = 3, on values uniform over int32 with a quarter each at
    INT32_MIN, -1 and 255 (the sums wrap); and all four operators with
    ``first`` None (each row one group) against the loop over rows with
    no group start."""
    first, marked = seg_scan_inputs(case, 3, n, seed=n)
    values = seg_scan_values(3, n, seed=n)
    f = first if grouped else None
    want = seg_scan_ref(f, marked, values)
    fns = ((seg_scan.last_marked, marked), (seg_scan.exclusive_count, marked),
           (seg_scan.running_max, values), (seg_scan.exclusive_sum, values))
    for (fn, x), ref in zip(fns, want):
        got = fn(f, x)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bad", ["dtype", "shape", "dim", "first_dtype"])
def test_seg_scan_rejects_bad_input(bad):
    first, marked = seg_scan_inputs("dense", 2, 100)
    values = seg_scan_values(2, 100)
    if bad == "dtype":
        marked, values = marked.int(), values.long()
    elif bad == "shape":
        marked, values = marked[:, :99], values[:, :99]
    elif bad == "dim":
        first, marked, values = first[0], marked[0], values[0]
    else:
        first = first.int()
    for fn, x in ((seg_scan.last_marked, marked),
                  (seg_scan.exclusive_count, marked),
                  (seg_scan.running_max, values),
                  (seg_scan.exclusive_sum, values)):
        with pytest.raises(ValueError):
            fn(first, x)


# --- the scan sites of MID2, the item merges and FRONT against the ATen
# expressions they ran before they called kernels/seg_scan.py (the
# functions as they were, kept here as the reference)


def _old_expand_b(start, kind, q, head_len, tail_len, n_items):
    bsz, mc = start.shape
    idx = ob._positions(bsz, mc, start.device).long()
    valid = idx < n_items.view(-1, 1)
    reps = torch.where(valid, 1 + tail_len.long(), 0)
    off = torch.cumsum(reps, dim=1) - reps
    total = (off[:, -1] + reps[:, -1]).int()
    sorted_off = torch.where(valid, torch.clamp(off, max=mc), mc)
    owner = torch.searchsorted(sorted_off.contiguous(), idx.contiguous(),
                               right=True) - 1
    owner = owner.clamp(min=0)
    o_start = ob.bgather(start, owner)
    o_hlen = ob.bgather(head_len, owner)
    within = idx - ob.bgather(off, owner)
    is_head = within == 0
    start2 = torch.where(is_head, o_start, o_start + o_hlen + within - 1)
    kind2 = torch.where(is_head, ob.bgather(kind, owner), 0)
    len2 = torch.where(is_head, o_hlen, 1)
    q2 = torch.where(is_head & (kind2 == 2), ob.bgather(q, owner), 0)
    live = idx < total.view(-1, 1)
    return (torch.where(live, start2, 0x7FFFFFFE).int(),
            torch.where(live, kind2, 0).int(),
            torch.where(live, len2, 0).int(),
            torch.where(live, q2, 0).int(), total)


def _old_cand_of_queries(o_role, o_pay, mc):
    last_item = torch.cummax(torch.where(o_role == 0, o_pay, -1),
                             dim=1).values
    return ob.scatter_queries(o_role == 1, o_pay, last_item, mc)


def _old_ranks_and_membership_b(start, kind, q, pk1, n_items):
    bsz, mc = start.shape
    idx = ob._positions(bsz, mc, start.device)
    valid = idx < n_items.view(-1, 1)
    cctx = (ob.bgather(pk1, torch.where(valid, start, 0)) >> 10) & 0xFF
    sk, si = torch.sort(torch.where(valid, cctx, 0x7FFF), dim=1, stable=True)
    gstart = torch.cummax(torch.where(ob._first_marks(sk), idx, 0),
                          dim=1).values
    srank = torch.empty_like(idx).scatter_(1, si, idx - gstart)
    is_m = (kind == 2) & valid
    _, _, o_role, o_pay = ob.merge_by_target(
        torch.where(valid, start, 0x7FFFFFFE),
        torch.where(is_m, q, ob.INT_MAX))
    cand = _old_cand_of_queries(o_role, o_pay, mc)
    hit = is_m & (ob.bgather(start, cand) == q)
    ro = torch.where(hit, srank - ob.bgather(srank, cand) - 1, 0)
    return srank, hit, ro, cand


def _old_rep0_b(start, kind, q, n_items):
    bsz, mc = start.shape
    idx = ob._positions(bsz, mc, start.device)
    is_m = (kind == 2) & (idx < n_items.view(-1, 1))
    dist = torch.where(is_m, start - q, 0)
    last_match = torch.cummax(torch.where(is_m, idx, -1), dim=1).values
    prev_match = torch.cat(
        [torch.full_like(last_match[:, :1], -1), last_match[:, :-1]], dim=1)
    prev_dist = torch.where(prev_match >= 0, ob.bgather(dist, prev_match), 0)
    return is_m & (dist == prev_dist) & (prev_dist > 0)


def _old_seg_cummax(first, v):
    seg = torch.cumsum(first.long(), dim=1)
    return torch.cummax(seg * 256 + v.long(), dim=1).values - seg * 256


def _old_context_ranks_b(ba, valid):
    bsz, n = valid.shape
    x = ob._positions(bsz, n, valid.device)
    sk, order = torch.sort(torch.where(valid, ba.cctx, ob.INT_MAX), dim=1,
                           stable=True)
    gstart = torch.cummax(torch.where(ob._first_marks(sk), x, 0),
                          dim=1).values
    (rank,) = ob._sort_back_b(order, (x - gstart,))
    return torch.where(valid, rank, 0)


def _random_parse(seed: int, mc: int = 700):
    """A batch of 3 parses as MID2 holds them: item starts ascending by
    each item's length from PAD_FRONT, literals, words and matches (2 to
    255 bytes, half of them aimed at an earlier item's start, so that
    ranks, hits and repeated distances occur), then garbage past n_items
    (700, 400 and 0 items); pk1 with 6 byte contexts (bits 10-17), and
    for the expansion each match's head length and tail (a third demoted
    to a literal head)."""
    rng = np.random.default_rng(seed)
    n_items = np.array([mc, 400, 0], np.int32)
    kind = rng.choice(3, (3, mc), p=[0.5, 0.2, 0.3]).astype(np.int32)
    length = np.where(kind == 2, np.minimum(rng.geometric(0.08, (3, mc)) + 1,
                                            255), np.where(kind == 1, 2, 1))
    start = PAD_FRONT + np.cumsum(length, axis=1) - length
    back = np.maximum(start - rng.integers(1, 3000, (3, mc)), 0)
    earlier = start[np.arange(3)[:, None],
                    (rng.random((3, mc)) * np.arange(mc)).astype(int)]
    q = np.where(rng.random((3, mc)) < 0.5, earlier, back)
    q = np.where(kind == 2, q, 0)
    head = np.where(rng.random((3, mc)) < 1 / 3, 1,
                    rng.integers(1, 256, (3, mc)) % length + 1)
    head_kind = np.where((kind == 2) & (head == 1) & (length > 1), 0, kind)
    tail = np.where(kind == 2, length - head, 0)
    dead = np.arange(mc) >= n_items[:, None]
    junk = rng.integers(0, 1 << 20, (4, 3, mc))
    start = np.where(dead, junk[0], start)
    kind = np.where(dead, junk[1] % 3, kind)
    head_kind = np.where(dead, junk[1] % 3, head_kind)
    q = np.where(dead, junk[2], q)
    tail = np.where(dead, junk[3] % 1000, tail)
    n = int(start[~dead].max(initial=0)) + 300
    pk1 = ((rng.integers(0, 6, (3, n)) << 10)
           | rng.integers(0, 1 << 10, (3, n)))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))

    return SimpleNamespace(
        start=t(start), kind=t(kind), head_kind=t(head_kind), q=t(q),
        length=t(length), head_len=t(np.where(dead, 1, head)),
        tail_len=t(tail), n_items=t(n_items), pk1=t(pk1), mc=mc,
        bufs=torch.from_numpy(rng.integers(0, 4, (3, n)).astype(np.uint8)))


def _merge(p):
    """The item merge of ``lengths_and_symbols`` (2 * mc slots): its
    (o_role, o_pay), group starts and merged query lengths."""
    valid = ob._positions(3, p.mc, "cpu") < p.n_items.view(-1, 1)
    is_match = p.kind == 2
    o, o_key, o_role, o_pay = ob.merge_by_target(
        torch.where(valid, p.start, 0x7FFFFFFE),
        torch.where(is_match & valid, p.q, ob.INT_MAX))
    q_len = torch.where(is_match, p.length, 0)
    o_len = torch.gather(torch.cat([torch.zeros_like(q_len), q_len], dim=1),
                         1, o)
    first = torch.cat([
        torch.ones((3, 1), dtype=torch.bool),
        (o_key[:, 1:] != o_key[:, :-1]) | (o_role[:, 1:] != o_role[:, :-1]),
    ], dim=1)
    return o_role, o_pay, first, o_len


def _site_calls(site, p):
    """(new, old): the site's function now and as it was, on the same
    arguments."""
    if site == "rep0_b":
        args = (p.start, p.kind, p.q, p.n_items)
        return ob.rep0_b(*args), _old_rep0_b(*args)
    if site == "cand_of_queries":
        o_role, o_pay = _merge(p)[:2]
        return (ob.cand_of_queries(o_role, o_pay, p.mc),
                _old_cand_of_queries(o_role, o_pay, p.mc))
    if site == "_seg_cummax":
        first, o_len = _merge(p)[2:]
        return ob._seg_cummax(first, o_len), _old_seg_cummax(first, o_len)
    if site == "_ranks_and_membership_b":
        args = (p.start, p.kind, p.q, p.pk1, p.n_items)
        return (otz2._ranks_and_membership_b(*args),
                _old_ranks_and_membership_b(*args))
    if site == "context_ranks_b":
        ba = ob.byte_arrays_b(p.bufs)
        x = ob._positions(3, p.bufs.shape[1], "cpu")
        valid = (x >= PAD_FRONT) & (x < torch.tensor([[x.shape[1] - 7],
                                                      [900], [PAD_FRONT]]))
        return ob.context_ranks_b(ba, valid), _old_context_ranks_b(ba, valid)
    args = (p.start, p.head_kind, p.q, p.head_len, p.tail_len, p.n_items)
    return otz2._expand_b(*args), _old_expand_b(*args)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("site", ["rep0_b", "cand_of_queries", "_seg_cummax",
                                  "_ranks_and_membership_b",
                                  "context_ranks_b", "_expand_b"])
def test_scan_sites_equal_their_aten_expressions(site, seed):
    """Each site whose ``torch.cummax`` or ``torch.cumsum`` became a
    ``kernels/seg_scan.py`` call returns what it returned before, in the
    same dtypes, on random parses with garbage past n_items (one row full,
    one empty) and their 2 * mc-slot item merges; MID2's expansion
    overflows mc in one row and not in another."""
    p = _random_parse(seed)
    new, old = _site_calls(site, p)
    new = new if isinstance(new, tuple) else (new,)
    old = old if isinstance(old, tuple) else (old,)
    assert len(new) == len(old)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    if site == "_expand_b":
        total = new[-1]
        assert bool((total > p.mc).any()) and bool((total <= p.mc).any())
