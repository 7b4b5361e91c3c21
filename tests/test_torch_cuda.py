"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false.  This module imports neither jax nor the repository's conftest, so
on a machine with a GPU and no jax it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

All outputs are integers: tolerance 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from orz_tpu_torch.device.host import S, _bucket, pad_batch
from orz_tpu_torch.kernels import (
    fence_walk,
    match_depth,
    match_depth_masked,
    symrank,
    walk_mask,
)
from orz_tpu_torch.ops import batched as ob
from orz_tpu_torch.spec import FENCE, OTZ2_RO_CAP, PAD_FRONT, RING
from torch_walk_inputs import (
    WALK_VARIANTS,
    fence_walk_inputs,
    walk_inputs,
    walk_plain,
)

CAP = 1 << 18

def walk(args, depth: int, variant: str):
    """K1 or K2 (``WALK_VARIANTS``) through its wrapper."""
    ro_cap, near, near_cap = WALK_VARIANTS[variant]
    if variant == "k1":
        return match_depth.match_depth(*args[:5], depth, ro_cap)
    return match_depth_masked.match_depth_masked(*args, depth, ro_cap, near,
                                                 near_cap)


def _data(seed: int, n: int) -> bytes:
    """Text-like words with long repeats, then binary runs and noise."""
    rng = np.random.default_rng(seed)
    vocab = [b"kernel", b"tensor", b"warp", b"block", b"the", b"of", b"a",
             b"0123456789", b"shared", b"memory", b"stream", b"(x)"]
    out = bytearray()
    while len(out) < n // 2:
        out += vocab[int(rng.integers(len(vocab)))] + b" "
        if rng.random() < 0.03:
            out += out[max(0, len(out) - 300):max(0, len(out) - 100)]
    while len(out) < n:
        if rng.random() < 0.5:
            out += bytes([int(rng.integers(256))]) * int(rng.integers(1, 80))
        else:
            out += rng.integers(0, 256, int(rng.integers(1, 100)),
                                dtype=np.uint8).tobytes()
    return bytes(out[:n])


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def batch(cuda):
    segs = [_data(1, CAP), _data(2, CAP - 777)]
    bufs, lens = pad_batch(segs, CAP)
    return segs, torch.from_numpy(bufs).to(cuda), torch.from_numpy(lens).to(cuda)


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [4, 8, 32])
def test_match_depth_kernel_matches_plain(batch, depth):
    _, bufs, lens = batch
    n = bufs.shape[1]
    p = torch.arange(n, device=bufs.device)
    valid = (p >= PAD_FRONT) & (p < (PAD_FRONT + lens).view(-1, 1))
    ba = ob.byte_arrays_b(bufs)
    args = ob.candidate_arrays_b(ba, ob.context_ranks_b(ba, valid), valid)
    end = (PAD_FRONT + lens).int()
    before = match_depth.launches
    got = match_depth.match_depth(*args, end, depth)
    torch.cuda.synchronize()
    assert match_depth.launches == before + 1
    _equal(got, match_depth.match_depth_plain(*args, end, depth))
    assert int((got[0] >= 0).sum()) > 10000


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["iteration", "conform"])
def test_match_depth_masked_kernel_matches_plain(batch, variant):
    """K2 at depth 384 with near gating at 96, on the FRONT parse's mask:
    the iteration cap, and the conform's two-tier cap."""
    _, bufs, lens = batch
    n = bufs.shape[1]
    p = torch.arange(n, device=bufs.device)
    valid = (p >= PAD_FRONT) & (p < (PAD_FRONT + lens).view(-1, 1))
    mask = ob.front_body_b(bufs, lens, 32)[6]
    plan = ob.masked_plan_b(bufs, lens)
    rank = ob.masked_context_counts_planned_b(plan, valid, mask)
    order = plan.msp.long()
    args = (plan.msk, plan.msp, torch.gather(rank, 1, order), plan.dw_s,
            (PAD_FRONT + lens).int(), torch.gather(mask, 1, order), 384)
    caps = (OTZ2_RO_CAP, 96, None) if variant == "iteration" \
        else (RING, 96, OTZ2_RO_CAP)
    before = match_depth_masked.launches
    got = match_depth_masked.match_depth_masked(*args, *caps)
    torch.cuda.synchronize()
    assert match_depth_masked.launches == before + 1
    _equal(got, match_depth.match_depth_plain(*args[:5], 384, caps[0],
                                              args[5], *caps[1:]))
    assert int((got[0] >= 0).sum()) > 10000


@pytest.mark.cuda
@pytest.mark.parametrize("variant,mask", [
    ("k1", "random"), ("iteration", "zeros"), ("iteration", "ones"),
    ("iteration", "random"), ("two_tier", "random")])
def test_match_depth_tiles_match_plain(cuda, variant, mask):
    """K1 and K2 at depth 384 on rows of 3077 slots (not a multiple of
    K2's 1024-slot tile): row 0 one key over three tiles, row 1 small
    groups; masks all 0, all 1 and random."""
    n = 3077
    rng = np.random.default_rng(5)
    small = list(rng.integers(1, 90, 60))
    args = tuple(t.to(cuda) for t in walk_inputs(3, n, [[n - 50], small],
                                                 mask))
    got = walk(args, 384, variant)
    torch.cuda.synchronize()
    _equal(got, walk_plain(args, 384, variant))
    if variant == "k1" or mask != "zeros":
        assert int((got[0] >= 0).sum()) > 500


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [4, 8, 32])
def test_match_depth_k1_tiles_match_plain(cuda, depth):
    """K1 at FRONT's depths on rows of 3 x 256 + 101 slots (three of its
    256-slot tiles and a ragged fourth): row 0's key groups start at slot 0
    and straddle the tile edges and their depth-slot halos (250 | 12 |
    30 | 300 | 200 slots: edges at 256, 512, 768), row 1 has small groups;
    positions reach the fence and segment-end caps."""
    n = 3 * 256 + 101
    rng = np.random.default_rng(8)
    groups = [[250, 12, 30, 300, 200], list(rng.integers(1, 40, 30))]
    args = tuple(t.to(cuda) for t in walk_inputs(9, n, groups))
    before = match_depth.launches
    got = walk(args, depth, "k1")
    torch.cuda.synchronize()
    assert match_depth.launches == before + 1
    _equal(got, walk_plain(args, depth, "k1"))
    assert int((got[0] >= 0).sum()) > 300


@pytest.mark.cuda
@pytest.mark.parametrize("n_extra", [288, 777])
def test_walk_kernels_match_plain_stress(cuda, n_extra):
    """K3 and K4 on the stress rows of ``fence_walk_inputs`` (every block
    kind in every row; segments ending inside a block, at the row's end,
    and empty) at n = PAD_FRONT + 24 blocks + n_extra: 288 keeps the rows
    16-byte aligned, 777 does not (the kernel's scalar paths).  The mask,
    K4's counts from the kernel and K3's starts."""
    n = PAD_FRONT + 24 * FENCE + n_extra
    lens = [24 * FENCE, 13 * FENCE + 1234, 0, 24 * FENCE + n_extra - 5]
    nxt, seg_lens = (t.to(cuda) for t in fence_walk_inputs(3, n, lens))
    want = fence_walk.fence_walk_mask_plain(nxt, seg_lens)
    before = (walk_mask.launches, fence_walk.launches)
    got = walk_mask.walk_mask(nxt, seg_lens)
    items = fence_walk.walk_items(nxt, seg_lens)
    torch.cuda.synchronize()
    assert (walk_mask.launches, fence_walk.launches) == (before[0] + 1,
                                                         before[1] + 1)
    _equal(got, (want, want.sum(dim=1).int()))
    _equal(items, (*fence_walk.starts_from_mask(want, seg_lens), want))
    assert bool(want[0, PAD_FRONT:PAD_FRONT + FENCE].all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k1_dtype", "k1_contiguous", "walk_dtype",
                                  "walk_shape", "walk_contiguous"])
def test_wrappers_raise_on_bad_cuda_input(cuda, case):
    """On CUDA tensors the K1 and K3/K4 wrappers raise on what their
    kernels cannot take, and launch nothing."""
    if case.startswith("k1"):
        args = [t.to(cuda) for t in walk_inputs(2, 600, [[300, 200]])][:5]
        if case == "k1_dtype":
            args[2] = args[2].long()
        else:  # same shape, every other column of a wider tensor
            wide = torch.zeros((1, 1200), dtype=torch.int32, device=cuda)
            wide[:, ::2] = args[0]
            args[0] = wide[:, ::2]
        before = match_depth.launches
        with pytest.raises(ValueError):
            match_depth.match_depth(*args, 32)
        assert match_depth.launches == before
        return
    nxt, lens = (t.to(cuda) for t in fence_walk_inputs(
        4, PAD_FRONT + FENCE + 100, [FENCE]))
    if case == "walk_dtype":
        nxt = nxt.long()
    elif case == "walk_shape":
        lens = lens.repeat(2)
    else:
        wide = torch.zeros((1, 2 * nxt.shape[1]), dtype=torch.int32,
                           device=cuda)
        wide[:, ::2] = nxt
        nxt = wide[:, ::2]
    before = (fence_walk.launches, walk_mask.launches)
    for fn in (fence_walk.fence_walk_mask, walk_mask.walk_mask):
        with pytest.raises(ValueError):
            fn(nxt, lens)
    assert (fence_walk.launches, walk_mask.launches) == before


@pytest.mark.cuda
def test_symrank_one_context_matches_plain(cuda):
    """K5 with every item in one context, m = 20013 (not a multiple of
    32), one row shorter than m."""
    rng = np.random.default_rng(11)
    bsz, m = 2, 20013
    sym = np.minimum(rng.zipf(1.3, (bsz, m)) - 1, S - 1)
    args = (torch.from_numpy(sym.astype(np.int32)),
            torch.from_numpy(rng.integers(0, 256, (bsz, m), dtype=np.int32)),
            torch.full((bsz, m), 300, dtype=torch.int32),
            torch.tensor([m - 5, m], dtype=torch.int32),
            torch.from_numpy(np.stack([rng.permutation(S) for _ in
                                       range(bsz)]).astype(np.int32)))
    before = symrank.launches
    got = symrank.symrank(*(t.to(cuda) for t in args))
    torch.cuda.synchronize()
    assert symrank.launches == before + 1
    assert torch.equal(got.cpu(), symrank.symrank_plain(*args))


@pytest.mark.cuda
def test_walk_mask_kernel_matches_plain(batch):
    _, bufs, lens = batch
    nxt = ob.decisions_b(ob.analyze_b(bufs, lens, 8), lens, bufs.shape[1]).nxt
    before = walk_mask.launches
    got = walk_mask.walk_mask(nxt, lens)
    torch.cuda.synchronize()
    assert walk_mask.launches == before + 1
    _equal(got, walk_mask.walk_mask_plain(nxt, lens))


@pytest.mark.cuda
def test_fence_walk_kernel_matches_plain(batch):
    _, bufs, lens = batch
    nxt = ob.decisions_b(ob.analyze_b(bufs, lens, 8), lens, bufs.shape[1]).nxt
    got = fence_walk.fence_walk_mask(nxt, lens)
    torch.cuda.synchronize()
    assert torch.equal(got, fence_walk.fence_walk_mask_plain(nxt, lens))


@pytest.mark.cuda
def test_symrank_kernel_matches_plain(batch):
    _, bufs, lens = batch
    st, ni, pk1, bq, bro, bufs, _ = ob.front_body_b(bufs, lens, 8)
    items, _, _ = ob.mid_body_b(st, ni, pk1, bq, bro, bufs, lens,
                                _bucket(int(ni.max()), 1 << 14, 2))
    _, _, order, _ = ob.census_b(items, 1 << 21, 1)
    args = (items.symbol, items.sr_unlikely, items.sr_ctx, items.n_items,
            order)
    got = symrank.symrank(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, symrank.symrank_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("level,rings_mode", [(1, 0), (2, 0), (2, None)])
def test_cuda_payloads_equal_cpu_payloads(batch, level, rings_mode):
    """l1, l2 with OTZ2 off, and the l2 default (OTZ2, its default
    schedule) on 2 x 64 KiB."""
    from orz_tpu_torch.device.batch import encode_segments_batch
    from orz_tpu_torch.device.container import decode_segment

    segs = [s[: 1 << 16] for s in batch[0]]
    got = encode_segments_batch(segs, level, rings_mode=rings_mode,
                                device="cuda")
    want = encode_segments_batch(segs, level, rings_mode=rings_mode,
                                 device="cpu")
    assert got == want
    for seg, payload in zip(segs, got):
        assert decode_segment(payload) == seg


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["in_window", "fill", "wrap", "clamp"])
def test_windowed_gather_kernel_matches_plain(cuda, case):
    """P1 on the probe's arrays at m = 2^16 and its four edge cases."""
    from orz_tpu_torch.kernels import windowed_gather as wg
    from orz_tpu_torch.tools.gather_probe import edge_cases, probe_data

    d = probe_data(16)
    idx, base = edge_cases(d["idx"], d["base"], d["src"].size)[case]
    src, idx, base = (torch.from_numpy(a).to(cuda)
                      for a in (d["src"], idx, base))
    before = wg.launches
    got = wg.windowed_gather(src, idx, base)
    torch.cuda.synchronize()
    assert wg.launches == before + 1
    assert torch.equal(got, wg.windowed_gather_plain(src, idx, base))


@pytest.mark.cuda
def test_cli_on_card_equals_cpu(batch, tmp_path):
    """The CLI's l1 file on the card equals its file on the CPU."""
    from orz_tpu_torch import cli

    src = tmp_path / "in.bin"
    src.write_bytes(batch[0][0][: 1 << 16])
    outs = {}
    for device in ("cuda", "cpu"):
        outs[device] = tmp_path / f"{device}.orz"
        assert cli.main(["encode", "-s", "-l", "1", str(src),
                         str(outs[device])], device=device) == 0
    assert outs["cuda"].read_bytes() == outs["cpu"].read_bytes()


@pytest.mark.cuda
def test_cuda_otz1_fallback_equals_cpu(batch, monkeypatch):
    """A segment whose repair failed takes the OTZ1 path on the card as on
    the CPU, and its payload is the plain rings_mode=0 encode."""
    from orz_tpu_torch.device import batch as tb

    segs = [s[: 1 << 14] for s in batch[0]]
    mid2 = tb.mid2_body

    def fail_first(*args, **kw):
        items, ok, *rest = mid2(*args, **kw)
        ok = ok.clone()
        ok[0] = False
        return (items, ok, *rest)

    monkeypatch.setattr(tb, "mid2_body", fail_first)
    monkeypatch.setenv("OTZ2_SCHEDULE", "96x1,384x2")
    got = tb.encode_segments_batch(segs, 2, device="cuda")
    assert got == tb.encode_segments_batch(segs, 2, device="cpu")
    assert got[0] == tb.encode_segments_batch(segs[:1], 2, rings_mode=0,
                                              device="cuda")[0]


@pytest.mark.cuda
def test_cli_gpu_decodes_jax_orzp(cuda, tmp_path):
    """decode -b gpu of an ORZP file that the JAX package's native host
    backend wrote (its host modules import no jax): through auto, on the
    machine that holds the card."""
    import io

    from orz_tpu import cfg_from_level, pcontainer
    from orz_tpu.native import NativeBackend
    from orz_tpu_torch import cli

    data = _data(5, 300_000)
    par = io.BytesIO()
    pcontainer.pencode(io.BytesIO(data), par, cfg_from_level(2),
                       NativeBackend(), num_streams=3, segment_size=1 << 16)
    src, out = tmp_path / "in.orzp", tmp_path / "out.bin"
    src.write_bytes(par.getvalue())
    assert cli.main(["decode", "-s", "-b", "gpu", str(src), str(out)]) == 0
    assert out.read_bytes() == data
