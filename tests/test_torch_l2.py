"""The torch port's l2 slice (QUALITY + MID2) against the JAX batched chain,
on the CPU.

The JAX programs that ``orz_tpu.device.batch.encode_segments_batch`` runs
at level 2 (b_front_jit, b_scan_jit, b_tail_jit, b_mid2_jit, b_back_jit)
run once per process on B=2 padded (cap 1<<15) buffers, with
``OTZ2_SCHEDULE=96x1,384x2``: a 96-shift scan step with no near gating,
384-shift full steps gated at OTZ2_NEAR=96, and the two-tier 384-shift
conform analyses, i.e. every code path of the default 96x1+384x11 at a
third of its cost.  Every stage output of the port equals JAX's, including
MID2's anomalous branch, and so do the payloads (JAX's are assembled from
its BACK outputs by its own ``assemble_segment_np``, as its
``encode_segments_batch`` does when every repair succeeded), which decode
through the native decoder.  The port's stage outputs are those of one run
of its ``encode_segments_batch``, read through its ``stage`` hook.  All
outputs are integers: tolerance 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from orz_tpu_torch.device import batch as tb
from orz_tpu_torch.device.container import decode_segment
from orz_tpu_torch.device.host import _bucket, pad_batch
from orz_tpu_torch.ops import batched as ob
from orz_tpu_torch.spec import CHUNK_INPUT_DEFAULT, n_chunks_for, otz2_schedule
from tests.conftest import make_binary_like, make_text_like

torch.set_num_threads(2)

CAP = 1 << 15
C_MAX = n_chunks_for(CAP, CHUNK_INPUT_DEFAULT)
SCHEDULE = "96x1,384x2"


@pytest.fixture(scope="module")
def segs():
    rng = np.random.default_rng(0x51CE)
    return [make_text_like(rng, 30000), make_binary_like(rng, 30000)]


@pytest.fixture(scope="module")
def schedule_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OTZ2_SCHEDULE", SCHEDULE)
        yield


def _np(tree):
    if isinstance(tree, tuple):
        return tuple(_np(t) for t in tree)
    return np.asarray(tree)


@pytest.fixture(scope="module")
def jax_chain(segs, schedule_env):
    import jax.numpy as jnp

    from orz_tpu.device.batch import (
        b_back_jit,
        b_front_jit,
        b_mid2_jit,
        b_scan_jit,
        b_tail_jit,
    )
    from orz_tpu.device.pipeline import assemble_segment_np
    from orz_tpu.golden.bitio import BitEncoder
    from orz_tpu.ops.symrank_pallas import RB_BLK

    head, tail, c_shifts = tb.quality_split(otz2_schedule(2))
    assert (head, tail, c_shifts) == ((96,), (384, 384), 384)
    bufs, lens = (jnp.asarray(a) for a in pad_batch(segs, CAP))
    st, ni, pk1, bq, bro, bufs_d, mask0 = b_front_jit(bufs, lens, 32)
    plan, mask, ni_h = b_scan_jit(bufs_d, lens, mask0, ni, head)
    it_a, it_b = b_tail_jit(bufs_d, lens, plan, st, ni, pk1, mask, tail,
                            c_shifts)
    m2_cap = tb.m2_cap_for(int(max(np.max(it_a[1]), np.max(it_b[1]))))
    mid2 = b_mid2_jit(bufs_d, lens, it_a, it_b, m2_cap)
    # the FRONT parse as iterate B: its matches target non-starts and
    # demote heavily, which takes the anomalous branch
    anom = b_mid2_jit(bufs_d, lens, it_a, (st, ni, pk1, it_b[3], it_b[4]),
                      m2_cap)
    items, ok, r1, rounds = mid2[:4]
    assert np.asarray(ok).all()  # no segment takes the OTZ1 fallback
    r1_h, r_h = np.asarray(r1), np.asarray(rounds)
    out = b_back_jit(items, CHUNK_INPUT_DEFAULT, C_MAX,
                     _bucket(max(int(r1_h.max()), 1), RB_BLK),
                     _bucket(max(int((r_h - r1_h).max()), 1), 4 * RB_BLK))
    metas, words = np.asarray(out.meta), np.asarray(out.words)
    payloads = []
    for b, seg in enumerate(segs):
        enc = BitEncoder()
        enc.encode_varint(len(seg))
        enc.encode_varint(CHUNK_INPUT_DEFAULT)
        payloads.append(assemble_segment_np(enc, metas[b], words[b],
                                            len(seg), CHUNK_INPUT_DEFAULT,
                                            rings_mode=1))
    return {
        "plan": _np(tuple(plan)), "mask": _np((mask, ni_h)),
        "it_a": _np(it_a), "it_b": _np(it_b), "m2_cap": m2_cap,
        "mid2": _np(tuple(mid2[0]) + tuple(mid2[1:])),
        "anom": _np(tuple(anom[0]) + tuple(anom[1:])),
        "back": (metas, words),
        "payloads": payloads,
    }


def _eq(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got.astype(np.int64),
                                  want.astype(np.int64), err_msg=what)


def _eq_iterate(got, want, what):
    st, ni, *rest = got
    _eq(ni, want[1], f"{what} n_items")
    for b, k in enumerate(want[1]):  # starts past n_items are filler
        _eq(st[b, :k], want[0][b, :k], f"{what} starts")
    for name, g, w in zip(("pk1", "bestq2", "bestlen2"), rest, want[2:]):
        _eq(g, w, f"{what} {name}")


def _eq_mid2(got, want, what):
    items, *rest = got
    names = ob.Items._fields + ("ok", "r1", "rounds", "dem_a", "dem_b")
    for name, g, w in zip(names, tuple(items) + tuple(rest), want):
        _eq(g, w, f"{what} {name}")


def test_l2_chain_matches_jax(segs, schedule_env, jax_chain):
    """Plan, mask carry, both iterates, MID2 (both branches), BACK and the
    payloads, stage by stage."""
    stages = {}

    def record(name, fn):
        stages[name] = fn()
        return stages[name]

    payloads = tb.encode_segments_batch(segs, 2, cap=CAP, device="cpu",
                                        stage=record)
    assert list(stages) == ["FRONT", "QUALITY scan", "QUALITY tail", "MID2",
                            "BACK"]
    st, ni, pk1 = stages["FRONT"][:3]

    plan, mask, ni_h = stages["QUALITY scan"]
    j_plan = jax_chain["plan"]
    for name, got in zip(ob.MaskedPlan._fields, plan):
        if name == "dw_s":
            want = np.stack(j_plan[9], axis=1).view(np.int32)
        else:
            want = j_plan[("sp_h2", "sval_h2", "first_h2", None, "sp_ctx",
                           "first_ctx", None, "msk", "msp").index(name)]
        _eq(got, want, f"plan {name}")
    for sp, dest in ((plan.sp_h2, j_plan[3]), (plan.sp_ctx, j_plan[6]),
                     (plan.msp, j_plan[10])):  # JAX's inverse permutations
        _eq(torch.argsort(sp, dim=1), dest, "plan dest")
    _eq(mask, jax_chain["mask"][0], "scan mask")
    _eq(ni_h, jax_chain["mask"][1], "scan n_items")

    it_a, it_b = stages["QUALITY tail"]
    _eq_iterate(it_a, jax_chain["it_a"], "iterate A")
    _eq_iterate(it_b, jax_chain["it_b"], "iterate B")

    _eq_mid2(stages["MID2"], jax_chain["mid2"], "mid2")
    bufs = stages["FRONT"][5]
    lens = torch.tensor([len(s) for s in segs], dtype=torch.int32)
    anom = tb.mid2_body(bufs, lens, it_a, (st, ni, pk1, it_b[3], it_b[4]),
                        jax_chain["m2_cap"])
    _eq_mid2(anom, jax_chain["anom"], "mid2 anomalous")
    dem_a, dem_b = anom[4], anom[5]
    assert bool((dem_b > torch.clamp(ni >> 7, min=1024)).any())
    assert not torch.equal(dem_a, dem_b)  # iterate A was emitted too

    metas, words = stages["BACK"]
    j_meta, j_words = jax_chain["back"]
    _eq(metas, j_meta, "back meta")
    for b in range(len(segs)):
        k = int(j_meta[b, 3])  # total_words
        _eq(words[b, :k], j_words[b, :k], "back words")

    assert payloads == jax_chain["payloads"]
    for seg, payload in zip(segs, payloads):
        assert decode_segment(payload) == seg


def test_repair_failure_falls_back_to_otz1(monkeypatch):
    """A segment whose OTZ2 repair failed is re-encoded through the OTZ1
    MID and BACK at B=1: its payload equals the oracle's rings_mode=0
    stream; the other segment keeps its l2 payload."""
    from orz_tpu.device.refcodec import encode_segment_ref

    monkeypatch.setenv("OTZ2_SCHEDULE", SCHEDULE)
    rng = np.random.default_rng(0xFA11)
    segs = [make_text_like(rng, 6000), make_binary_like(rng, 5000)]
    normal = tb.encode_segments_batch(segs, 2, device="cpu")

    mid2 = tb.mid2_body

    def fail_first(*args, **kw):
        items, ok, *rest = mid2(*args, **kw)
        ok = ok.clone()
        ok[0] = False
        return (items, ok, *rest)

    monkeypatch.setattr(tb, "mid2_body", fail_first)
    got = tb.encode_segments_batch(segs, 2, device="cpu")
    assert got[0] == encode_segment_ref(segs[0], 2, rings_mode=0)
    assert got[0] != normal[0]
    assert got[1] == normal[1]
    for seg, payload in zip(segs, got):
        assert decode_segment(payload) == seg
