"""Inputs built to stress the kernels' walks, shared by the CPU tests
(``test_torch_kernels.py``) and the card tests (``test_torch_cuda.py``):
K1/K2's candidate walk and K3/K4's fence-block walk.

Imports neither jax nor the repository's conftest, so that the card tests
run on a machine without jax."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from orz_tpu_torch.device.host import N_DW
from orz_tpu_torch.kernels import match_depth
from orz_tpu_torch.spec import FENCE, OTZ2_RO_CAP, PAD_FRONT, RING

# K1's and K2's variants: (ro_cap, near_depth, ro_cap_near)
WALK_VARIANTS = {"k1": (RING, 0, None), "iteration": (OTZ2_RO_CAP, 96, None),
                 "two_tier": (RING, 96, OTZ2_RO_CAP)}


def walk_inputs(seed: int, n: int, groups: list[list[int]],
                mask: str = "random"):
    """K1/K2 inputs (msk, msp, rank_s, dw_s, end, mask_s), (B, n) in
    sorted order, one row per entry of ``groups``, built to stress the
    walk: the row's keys are groups of the given sizes, then invalid slots
    (key INT_MAX, positions past the segment end); positions ascend within
    a group and straddle a fence boundary, and the last valid ones lie
    within 64 bytes of the end; ranks walk by -60..99 a slot and by
    +-4500 at one slot in ten (not monotone), so offsets cross the far
    gates and the caps in both directions along a walk; the 64 payload
    bytes equal one shared template up to a random byte (all 64 for a
    quarter of the slots), so LCPs tie often and reach the cap; ``mask``
    "random" (30% ones), "zeros" or "ones"."""
    rng = np.random.default_rng(seed)
    bsz = len(groups)
    msk = np.full((bsz, n), 2**31 - 1, np.int32)
    msp = np.zeros((bsz, n), np.int32)
    base = PAD_FRONT + FENCE - 700
    ends = []
    for b, sizes in enumerate(groups):
        n_valid = sum(sizes)
        perm = base + rng.permutation(n_valid)
        at = 0
        for key, size in enumerate(sizes):
            msk[b, at:at + size] = key
            msp[b, at:at + size] = np.sort(perm[at:at + size])
            at += size
        msp[b, n_valid:] = base + np.arange(n_valid, n)
        ends.append(base + n_valid)
    jump = (rng.random((bsz, n)) < 0.1) * rng.choice([4500, -4500], (bsz, n),
                                                      p=[0.7, 0.3])
    rank = np.cumsum(rng.integers(-60, 100, (bsz, n)) + jump, axis=1)
    template = rng.integers(0, 256, 4 * N_DW, dtype=np.uint8)
    cut = np.where(rng.random((bsz, n)) < 0.25, 4 * N_DW,
                   rng.integers(0, 4 * N_DW, (bsz, n)))
    pay = np.broadcast_to(template, (bsz, n, 4 * N_DW)).copy()
    noise = rng.integers(0, 256, pay.shape, dtype=np.uint8)
    after = np.arange(4 * N_DW) >= cut[..., None]
    pay = np.where(after, noise, pay)
    first = np.arange(4 * N_DW) == cut[..., None]  # differs at the cut
    pay = np.where(first & (pay == template), pay ^ 0x5A, pay)
    dw = pay.view("<u4").view(np.int32).transpose(0, 2, 1)
    mask_s = {"random": rng.random((bsz, n)) < 0.3,
              "zeros": np.zeros((bsz, n), bool),
              "ones": np.ones((bsz, n), bool)}[mask]
    return (torch.from_numpy(msk), torch.from_numpy(msp),
            torch.from_numpy(rank.astype(np.int32)),
            torch.from_numpy(np.ascontiguousarray(dw)),
            torch.tensor(ends, dtype=torch.int32), torch.from_numpy(mask_s))


def walk_plain(args, depth: int, variant: str):
    ro_cap, near, near_cap = WALK_VARIANTS[variant]
    mask_s = None if variant == "k1" else args[5]
    return match_depth.match_depth_plain(*args[:5], depth, ro_cap, mask_s,
                                         near, near_cap)


# K3/K4 block kinds (``fence_walk_inputs``): how a block's items are laid out
WALK_KINDS = ("literals", "thirds", "short", "leaving", "edges", "long")


def fence_walk_inputs(seed: int, n: int, lens: list[int],
                      first: list[int] | None = None):
    """K3/K4 inputs ``(nxt, seg_lens)``: (B, n) int32 jumps and (B,)
    int32 segment lengths.  Block k of row b takes the kind
    ``WALK_KINDS[(first[b] + k) % 6]`` (``first`` defaults to the row
    numbers): FENCE length-1 items (the longest chain);
    items of 3 (the chunk starts of the chunked walk miss the true path, so
    its fix-ups never merge); random lengths 1..20; lengths 1..600 with 2%
    jumps past the block; length 1 with 5% jumps to the next 128-position
    chunk edge, the block's end or far past n; random lengths 1..FENCE.
    Every jump goes forward (nxt[p] > p), as the parse's do: the plain
    walk follows nxt unclipped, the kernels clip it to the block."""
    rng = np.random.default_rng(seed)
    bsz = len(lens)
    first = range(bsz) if first is None else first
    nxt = np.zeros((bsz, n), np.int64)
    for b in range(bsz):
        for base in range(PAD_FRONT, n, FENCE):
            pos = np.arange(base, min(base + FENCE, n))
            kind = WALK_KINDS[(first[b] + (base - PAD_FRONT) // FENCE) % 6]
            size = pos.size
            if kind == "literals":
                step = np.ones(size, np.int64)
            elif kind == "thirds":
                step = np.full(size, 3)
            elif kind == "short":
                step = rng.integers(1, 21, size)
            elif kind == "leaving":
                step = np.where(rng.random(size) < 0.02, 5000,
                                rng.integers(1, 601, size))
            elif kind == "edges":
                edge = np.stack([(pos - base) // 128 * 128 + 128,
                                 np.full(size, FENCE),
                                 np.full(size, 2**30)])[
                    rng.integers(0, 3, size), np.arange(size)] + base - pos
                step = np.where(rng.random(size) < 0.05, edge, 1)
            else:
                step = rng.integers(1, FENCE + 1, size)
            nxt[b, pos] = np.clip(pos + step, -2**31, 2**31 - 1)
    return (torch.from_numpy(nxt.astype(np.int32)),
            torch.tensor(lens, dtype=torch.int32))
