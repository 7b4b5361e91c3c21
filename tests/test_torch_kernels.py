"""Each kernel module of the torch port against its JAX counterpart.

On the CPU every kernel wrapper runs its plain torch version; these tests
hold those plain versions to the JAX package at B=2, cap=1<<15, on arrays
from a real FRONT: K1 against ``match_depth_pallas`` (interpret mode), K3
against ``walk_items_b`` (what the JAX package runs off the TPU), K5
against ``symrank_pallas_b`` (interpret mode) and the sequential oracle.
All outputs are integers: tolerance 0.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orz_tpu.device.spec import PAD_FRONT
from orz_tpu_torch.device.host import N_DW, _bucket, pad_batch
from orz_tpu_torch.kernels import fence_walk, match_depth, symrank
from orz_tpu_torch.ops import batched as ob
from tests.conftest import make_binary_like, make_text_like

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
    from orz_tpu.ops.match_pallas import match_depth_pallas

    msk, msp, rank_s, dw_s, end = candidates
    got = match_depth.match_depth(msk, msp, rank_s, dw_s, end, depth)
    assert int((got[0] >= 0).sum()) > 1000  # real candidates were found
    for b in range(msk.shape[0]):
        want = match_depth_pallas(
            jnp.asarray(msk[b].numpy()), jnp.asarray(msp[b].numpy()),
            jnp.asarray(rank_s[b].numpy()),
            tuple(jnp.asarray(dw_s[b, t].numpy()) for t in range(N_DW)),
            jnp.int32(int(end[b])), depth=depth,
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


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


@pytest.mark.parametrize("bad", ["dtype", "shape", "depth"])
def test_match_depth_rejects_bad_input(candidates, bad):
    msk, msp, rank_s, dw_s, end = candidates
    depth = 8
    if bad == "dtype":
        msk = msk.long()
    elif bad == "shape":
        dw_s = dw_s[:, :4]
    else:
        depth = 1024
    with pytest.raises(ValueError):
        match_depth.match_depth(msk, msp, rank_s, dw_s, end, depth)
