"""K1: the unmasked candidate depth loop (``csrc/match_depth.cu``).

Replaces ``orz_tpu/ops/match_pallas.py`` ``match_depth_pallas`` with
``mask_s=None``.  Inputs are ``(B, n)`` int32 arrays sorted by (match key,
position) and ``dw_s`` ``(B, N_DW, n)`` int32 (uint32 bit patterns);
outputs ``(best_q, best_ro, best_len)`` ``(B, n)`` int32 in sorted order.
``match_depth_plain`` and ``check_inputs`` serve K2
(``match_depth_masked``) too.
"""

from __future__ import annotations

import torch

from orz_tpu_torch import trace
from orz_tpu_torch.device.host import N_DW
from orz_tpu_torch.kernels import _lib
from orz_tpu_torch.spec import (
    FAR_RO_1,
    FAR_RO_2,
    FENCE,
    LZ_MATCH_MIN_LEN,
    PAD_FRONT,
    RING,
    _FAR_GATE,
)

launches = 0  # kernel launches (not plain-version calls) since last reset


def min_match_len_for_ro(ro: torch.Tensor) -> torch.Tensor:
    """``orz_tpu.device.spec.min_match_len_for_ro`` as int32 torch."""
    return (LZ_MATCH_MIN_LEN + _FAR_GATE * (ro >= FAR_RO_1).int()
            + _FAR_GATE * (ro >= FAR_RO_2).int()).int()


def lcp_from_xor(x: torch.Tensor) -> torch.Tensor:
    """Equal leading (little-endian) bytes of one dword pair, from its XOR
    (int32 bit pattern); 4 when the dwords are equal."""
    b0 = (x & 0xFF) == 0
    b1 = (x & 0xFFFF) == 0
    b2 = (x & 0xFFFFFF) == 0
    part = b0.int() + (b0 & b1).int() + (b0 & b1 & b2).int()
    return torch.where(x != 0, part, 4)


def shift_dn(x: torch.Tensor, j: int, fill: int) -> torch.Tensor:
    """x shifted j slots toward higher indices along the last axis."""
    out = torch.full_like(x, fill)
    out[..., j:] = x[..., :-j]
    return out


def match_depth_plain(msk, msp, rank_s, dw_s, end, depth: int,
                      ro_cap: int = RING, mask_s=None, near_depth: int = 0,
                      ro_cap_near: int | None = None):
    """The TPU kernel's rounds j = 1..depth, one shift at a time: the
    (slot, candidate) pairs that pass the key, mask and offset gates are
    compacted and only they compare dwords.  ``mask_s`` None is K1; a
    (B, n) bool mask is K2 (see ``csrc/match_depth.cu``)."""
    bsz, n = msk.shape
    end = end.view(-1, 1)
    cap = torch.minimum(FENCE - ((msp - PAD_FRONT) & (FENCE - 1)), end - msp)
    best_s = torch.zeros_like(msk)
    best_q = torch.full_like(msk, -1)
    best_ro = torch.zeros_like(msk)
    best_len = torch.zeros_like(msk)
    two_tier = mask_s is not None and ro_cap_near is not None \
        and ro_cap_near < ro_cap
    for j in range(1, min(depth, n - 1) + 1):
        same = torch.zeros_like(msk, dtype=torch.bool)
        same[:, j:] = msk[:, j:] == msk[:, :-j]
        if not bool(same.any()):  # sorted keys: no pair at any larger j
            break
        ro = rank_s - 1 - shift_dn(rank_s, j, 0)
        ok = same & (ro < ro_cap)
        if mask_s is not None:
            ok &= shift_dn(mask_s, j, False)
            if near_depth and j > near_depth:
                ok &= mask_s
        b, i = ok.nonzero(as_tuple=True)
        if b.numel() == 0:
            continue
        x = dw_s[b, :, i] ^ dw_s[b, :, i - j]  # (pairs, N_DW)
        nz = x != 0
        t = nz.int().argmax(dim=1)  # first differing dword
        xt = x.gather(1, t.view(-1, 1)).squeeze(1)
        lcp = torch.where(nz.any(dim=1), 4 * t + lcp_from_xor(xt), 4 * N_DW)
        lcp = torch.minimum(lcp, cap[b, i])
        ro_p = ro[b, i]
        good = lcp >= min_match_len_for_ro(ro_p)
        score = torch.where(good, lcp * 1024 + (1023 - j), -1)
        if two_tier:
            score = torch.where(good & (ro_p >= ro_cap_near), lcp, score)
        better = score > best_s[b, i]
        b, i = b[better], i[better]
        best_s[b, i] = score[better].int()
        best_q[b, i] = msp[b, i - j]
        best_ro[b, i] = ro_p[better]
        best_len[b, i] = lcp[better].int()
    return best_q, best_ro, best_len


def check_inputs(name: str, msk, msp, rank_s, dw_s, end, depth: int) -> None:
    bsz, n = msk.shape
    for arg, t, shape in (("msk", msk, (bsz, n)), ("msp", msp, (bsz, n)),
                          ("rank_s", rank_s, (bsz, n)),
                          ("dw_s", dw_s, (bsz, N_DW, n)),
                          ("end", end, (bsz,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be int32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if not 0 < depth < 1024:  # score packs lcp*1024 + recency
        raise ValueError(f"{name}: depth {depth} outside [1, 1023]")


def match_depth(msk, msp, rank_s, dw_s, end, depth: int, ro_cap: int = RING):
    """K1 on CUDA tensors; the plain version on CPU tensors."""
    check_inputs("match_depth", msk, msp, rank_s, dw_s, end, depth)
    if msk.device.type == "cpu":
        return match_depth_plain(msk, msp, rank_s, dw_s, end, depth, ro_cap)
    stream = _lib.cuda_stream("match_depth", msk, msp, rank_s, dw_s, end)
    bsz, n = msk.shape
    out = tuple(torch.empty_like(msk) for _ in range(3))
    rc = _lib.library().otz_match_depth(
        msk.data_ptr(), msp.data_ptr(), rank_s.data_ptr(), dw_s.data_ptr(),
        end.data_ptr(), *(t.data_ptr() for t in out), bsz, n, depth, ro_cap,
        FENCE, PAD_FRONT, LZ_MATCH_MIN_LEN, _FAR_GATE, FAR_RO_1, FAR_RO_2,
        N_DW, stream,
    )
    _lib.check(rc, "match_depth")
    trace.count(globals())
    return out
