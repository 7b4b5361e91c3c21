"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false.  This module imports neither jax nor the repository's conftest, so
on a machine with a GPU and no jax it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

All outputs are integers: tolerance 0.
"""

import numpy as np
import pytest
import torch

from orz_tpu.device.spec import PAD_FRONT
from orz_tpu_torch.device.host import _bucket, pad_batch
from orz_tpu_torch.kernels import fence_walk, match_depth, symrank
from orz_tpu_torch.ops import batched as ob

CAP = 1 << 18


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
@pytest.mark.parametrize("level", [1, 2])
def test_cuda_payloads_equal_cpu_payloads(batch, level):
    from orz_tpu.native.otz import decode_segment_native
    from orz_tpu_torch.device.batch import encode_segments_batch

    segs = [s[: 1 << 16] for s in batch[0]]
    got = encode_segments_batch(segs, level, rings_mode=0, device="cuda")
    want = encode_segments_batch(segs, level, rings_mode=0, device="cpu")
    assert got == want
    for seg, payload in zip(segs, got):
        assert decode_segment_native(payload) == seg
