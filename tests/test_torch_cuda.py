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
    seg_scan,
    symrank,
    walk_mask,
)
from orz_tpu_torch.ops import batched as ob
from orz_tpu_torch.spec import FENCE, OTZ2_RO_CAP, PAD_FRONT, RING
from torch_walk_inputs import (
    SEG_SCAN_CASES,
    WALK_VARIANTS,
    fence_walk_inputs,
    seg_scan_inputs,
    seg_scan_values,
    walk_inputs,
    walk_plain,
)

CAP = 1 << 18

SEG_SCAN_OPS = ((seg_scan.last_marked, seg_scan.last_marked_plain),
                (seg_scan.exclusive_count, seg_scan.exclusive_count_plain),
                (seg_scan.running_max, seg_scan.running_max_plain),
                (seg_scan.exclusive_sum, seg_scan.exclusive_sum_plain))


def _seg_scan_equal(first, marked, values):
    """The four segmented-scan kernels equal their plain versions, with
    the groups of ``first`` and with none (``first`` None): 8 launches."""
    before = seg_scan.launches
    for f in (first, None):
        for (fn, plain), x in zip(SEG_SCAN_OPS, (marked, marked, values,
                                                  values)):
            got = fn(f, x)
            assert got.dtype == torch.int32
            assert torch.equal(got, plain(f, x)), fn.__name__
    assert seg_scan.launches == before + 8


def _seg_scan_case(cuda, case, bsz, n, seed):
    first, marked = seg_scan_inputs(case, bsz, n, seed)
    return (first.to(cuda), marked.to(cuda),
            seg_scan_values(bsz, n, seed).to(cuda))


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


def _binary(seed: int, n: int) -> bytes:
    """Blocks of 32 noise bytes, each followed by a 32-byte run: about 0.53
    items a byte, so an 8 MiB segment takes MID2's 8,388,608-item bucket."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        out += rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        out += bytes([int(rng.integers(256))]) * 32
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
                                  "walk_shape", "walk_contiguous",
                                  "scan_dtype", "scan_contiguous",
                                  "scan_devices"])
def test_wrappers_raise_on_bad_cuda_input(cuda, case):
    """On CUDA tensors the K1, K3/K4 and segmented-scan wrappers raise on
    what their kernels cannot take, and launch nothing."""
    if case.startswith("scan"):
        first, marked, values = _seg_scan_case(cuda, "dense", 2, 1000, 0)
        if case == "scan_dtype":
            marked, values = marked.to(torch.uint8), values.long()
        elif case == "scan_contiguous":  # every other column of a wider row
            wide = torch.zeros((2, 2000), dtype=torch.bool, device=cuda)
            wide[:, ::2] = first
            first = wide[:, ::2]
        else:
            marked, values = marked.cpu(), values.cpu()
        before = seg_scan.launches
        for (fn, _), x in zip(SEG_SCAN_OPS, (marked, marked, values,
                                             values)):
            with pytest.raises(ValueError):
                fn(first, x)
        assert seg_scan.launches == before
        return
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
def test_short_batches_equal_the_padded_batch_at_8mib(cuda, monkeypatch):
    """At 8 MiB l2 (the default schedule), a batch of 1, 2 or 3 segments
    gives the payloads that they take in a batch of 4 padded with copies of
    the first, as the JAX package's loop pads a file's last batch.  The
    first segment is binary and takes MID2's 8,388,608-item bucket; the
    third is a short text tail."""
    import os

    from orz_tpu_torch.device import batch as tb
    from orz_tpu_torch.device.container import decode_segment, segment_encoders

    for k in [k for k in os.environ if k.startswith(("OTZ", "ORZ"))]:
        monkeypatch.delenv(k)
    m2_caps = []
    m2_cap_for = tb.m2_cap_for
    monkeypatch.setattr(tb, "m2_cap_for",
                        lambda n: m2_caps.append(m2_cap_for(n)) or m2_caps[-1])
    n = 8 << 20
    segs = [_binary(31, n), _data(32, n), _data(33, n - 1234567)]
    encode_batch, _ = segment_encoders(2, device="cuda")
    for k in (1, 2, 3):
        padded = encode_batch(segs[:k] + segs[:1] * (4 - k))
        got = encode_batch(segs[:k])
        assert got == padded[:k], k
    assert m2_caps == [1 << 23] * 6
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


@pytest.mark.cuda
def test_inflight_on_card_equals_cpu(cuda, monkeypatch):
    """ORZ_INFLIGHT=2 on the card: three one-segment l2 batches (the short
    schedule) in flight two at a time, each slot on its own stream, give
    the CPU encode's bytes and the launch counts of ORZ_INFLIGHT=1."""
    from orz_tpu_torch.device import container
    from orz_tpu_torch.kernels import windowed_gather

    mods = (match_depth, match_depth_masked, fence_walk, walk_mask, symrank,
            windowed_gather)
    monkeypatch.setenv("OTZ2_SCHEDULE", "96x1,384x2")
    data = _data(7, 3 << 14)
    kw = dict(level=2, segment_size=1 << 14, batch=1)
    streams, counts = {}, {}
    for inflight in ("1", "2"):
        monkeypatch.setenv("ORZ_INFLIGHT", inflight)
        torch.cuda.synchronize()
        for mod in mods:
            mod.launches = 0
        container.segment_retries = 0
        streams[inflight] = container.torch_encode_bytes(data, device="cuda",
                                                         **kw)
        torch.cuda.synchronize()
        counts[inflight] = [mod.launches for mod in mods]
        assert container.segment_retries == 0
    assert streams["2"] == streams["1"]
    assert counts["2"] == counts["1"]
    assert all(counts["2"][:5]), counts["2"]
    monkeypatch.setenv("ORZ_INFLIGHT", "1")
    assert streams["2"] == container.torch_encode_bytes(data, device="cpu",
                                                        **kw)
    assert container.torch_decode_bytes(streams["2"]) == data


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["batched", "staged"])
def test_parity_case_s_l2_on_card_equals_jax(cuda, path, monkeypatch):
    """Case S at l2 (two 128 KiB segments, four 32 KiB chunks each, the
    default schedule) on the card gives JAX's committed payload digests
    (tests/torch_parity_digests.json, from orz_tpu on XLA:CPU) and
    round-trips through the native decoder."""
    import json
    import os

    from orz_tpu_torch.device import container
    from orz_tpu_torch.tools import parity_data as pd

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "torch_parity_digests.json")) as f:
        rec = json.load(f)["cases"]["S-l2"]
    for k in [k for k in os.environ if k.startswith(("OTZ", "ORZ"))]:
        monkeypatch.delenv(k)
    if path == "staged":
        monkeypatch.setenv("ORZ_PER_SEGMENT", "1")
    data = pd.make_parity_data(rec["seed"], rec["n"], rec["segment_size"])
    stream = container.torch_encode_bytes(
        data, rec["level"], segment_size=rec["segment_size"],
        chunk_input=rec["chunk_input"], batch=rec["batch"], device="cuda")
    assert pd.parity_faults(rec, path, data, stream) == []
    assert container.torch_decode_bytes(stream) == data


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 2])
def test_host_syncs_are_the_sync_debug_modes(cuda, level, monkeypatch):
    """The program counts (``trace.host_syncs``) each host sync of a batch
    that ``torch.cuda.set_sync_debug_mode("warn")`` reports, and no
    other."""
    from orz_tpu_torch.tools.sync_sites import batch_syncs

    monkeypatch.setenv("OTZ2_SCHEDULE", "96x1,384x2")
    segs = [_data(11, 1 << 16), _data(12, (1 << 16) - 99)]
    batch_syncs(segs, level)  # warm: the library's load, first allocations
    seen, counted, sites, names = batch_syncs(segs, level)
    assert seen == counted == len(names), (sites, names)


@pytest.mark.cuda
def test_spans_share_the_profilers_clock_on_card(cuda):
    """Under torch.profiler with CUDA activity only (as the benchmark
    traces), every CUDA runtime launch of a batch lies within the program's
    ``batch`` span, and within one of its stages or host syncs."""
    from torch.profiler import ProfilerActivity, profile

    from orz_tpu_torch import trace
    from orz_tpu_torch.device.batch import encode_segments_batch

    segs = [_data(13, 1 << 16)] * 2
    encode_segments_batch(segs, 1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace.start()
        try:
            encode_segments_batch(segs, 1, device="cuda")
        finally:
            spans = trace.stop()
        torch.cuda.synchronize()
    launches = [(e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events()
                if e.name() == "cudaLaunchKernel"]
    (b,) = [s for s in spans if s["name"] == "batch"]
    stages = [s for s in spans if s["name"] in ("FRONT", "MID", "BACK")
              or s["name"].startswith("sync.")]
    assert len(launches) > 20
    assert all(b["start"] <= lo <= hi <= b["end"] for lo, hi in launches)
    assert all(any(s["start"] <= lo <= hi <= s["end"] for s in stages)
               for lo, hi in launches)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SEG_SCAN_CASES)
@pytest.mark.parametrize("n", [1, seg_scan.TILE - 1, seg_scan.TILE,
                               seg_scan.TILE + 1])
def test_seg_scan_kernel_matches_plain(cuda, case, n):
    """Rows of one slot, one tile less one, one tile and one tile and one
    (rows after the first then start off 16-byte alignment: the kernel's
    scalar loads and stores), B = 3; values at INT32_MIN, -1, 255 and
    uniform over int32."""
    _seg_scan_equal(*_seg_scan_case(cuda, case, 3, n, n))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tile_edges", "one_group", "no_marks"])
def test_seg_scan_look_back_chain(cuda, case):
    """Rows of 40 tiles and more: groups over 3 or more tiles (up to 38:
    a look-back may pass more than one window of 32 descriptors), and
    the same rows at an odd offset from the allocation (the scalar loads
    on every row)."""
    n = 40 * seg_scan.TILE + 77
    first, marked, values = _seg_scan_case(cuda, case, 2, n, 5)
    _seg_scan_equal(first, marked, values)
    buf = torch.zeros(2 * (2 * n + 1), dtype=torch.bool, device=cuda)
    off_first = buf[1:2 * n + 1].view(2, n)
    off_marked = buf[2 * n + 2:].view(2, n)
    off_first.copy_(first)
    off_marked.copy_(marked)
    off_values = torch.zeros(2 * n + 1, dtype=torch.int32,
                             device=cuda)[1:].view(2, n)
    off_values.copy_(values)
    _seg_scan_equal(off_first, off_marked, off_values)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sparse", "dense"])
@pytest.mark.parametrize("bsz", [1, 4])
def test_seg_scan_main_path_shape(cuda, case, bsz):
    """B = 1 (the staged encoder) and B = 4 (a batch) at 8 MiB + PAD_FRONT
    slots, group starts at densities 1e-4 and 0.5."""
    _seg_scan_equal(*_seg_scan_case(cuda, case, bsz, (8 << 20) + PAD_FRONT,
                                    bsz))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << 22, 1 << 24])
@pytest.mark.parametrize("bsz", [1, 4])
def test_seg_scan_item_space_shapes(cuda, bsz, n):
    """B = 1 and 4 at 2^22 and 2^24 slots: MID2's item rows and the item
    merges' 2 * mc rows at its 8,388,608-item bucket."""
    _seg_scan_equal(*_seg_scan_case(cuda, "sparse", bsz, n, 7))


# seg_scan.launches of one 4 x 8 MiB batch of test_batch_runs_no_aten_row_
# scan's segments, counted on an H100.  l1: FRONT's context_ranks_b, then
# MID's rep0_b, cand_of_queries and _seg_cummax.  l2 adds QUALITY's masked
# analyses and MID2's repair loop, whose passes follow the data.
SEG_SCAN_LAUNCHES = {1: 4, 2: 71}


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 2])
def test_batch_runs_no_aten_row_scan(cuda, level, monkeypatch):
    """Under torch.profiler, a 4 x 8 MiB batch (two binary segments, two
    text-like ones; the default schedule) launches no ATen cummax
    (``scan_innermost_dim_with_indices``), and ``seg_scan.launches`` rises
    by the count recorded for it."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from orz_tpu_torch.device.batch import encode_segments_batch

    for k in [k for k in os.environ if k.startswith(("OTZ", "ORZ"))]:
        monkeypatch.delenv(k)
    n = 8 << 20
    segs = [_binary(41, n), _data(42, n), _binary(43, n), _data(44, n)]
    encode_segments_batch(segs, level, device="cuda")
    torch.cuda.synchronize()
    before = seg_scan.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        encode_segments_batch(segs, level, device="cuda")
        torch.cuda.synchronize()
    got = seg_scan.launches - before
    kernels = {e.key for e in prof.key_averages()}
    assert any("seg_scan_kernel" in k for k in kernels)
    assert not [k for k in kernels if "scan_innermost_dim_with_indices" in k]
    assert got == SEG_SCAN_LAUNCHES[level], (level, got)
