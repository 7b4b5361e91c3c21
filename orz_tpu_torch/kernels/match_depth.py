"""K1: the unmasked candidate depth loop (``csrc/match_depth.cu``).

Replaces ``orz_tpu/ops/match_pallas.py`` ``match_depth_pallas`` with
``mask_s=None``.  Inputs are ``(B, n)`` int32 arrays sorted by (match key,
position) and ``dw_s`` ``(B, N_DW, n)`` int32 (uint32 bit patterns);
outputs ``(best_q, best_ro, best_len)`` ``(B, n)`` int32 in sorted order.
"""

from __future__ import annotations

import torch

from orz_tpu.device.spec import (
    FAR_RO_1,
    FAR_RO_2,
    FENCE,
    LZ_MATCH_MIN_LEN,
    PAD_FRONT,
    RING,
    _FAR_GATE,
)
from orz_tpu_torch.device.host import N_DW
from orz_tpu_torch.kernels import _lib

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
                      ro_cap: int = RING):
    """The shifted-tensor loop over j = 1..depth (the TPU kernel's rounds,
    and the XLA loop before it)."""
    end = end.view(-1, 1)
    cap = torch.minimum(FENCE - ((msp - PAD_FRONT) & (FENCE - 1)), end - msp)
    best_s = torch.zeros_like(msk)
    best_q = torch.full_like(msk, -1)
    best_ro = torch.zeros_like(msk)
    best_len = torch.zeros_like(msk)
    for j in range(1, depth + 1):
        ro = rank_s - 1 - shift_dn(rank_s, j, 0)
        ok = (shift_dn(msk, j, -1) == msk) & (ro < ro_cap)
        lcp = torch.full_like(msk, 4 * N_DW)
        for t in range(N_DW - 1, -1, -1):
            x = dw_s[:, t] ^ shift_dn(dw_s[:, t], j, 0)
            lcp = torch.where(x != 0, 4 * t + lcp_from_xor(x), lcp)
        lcp = torch.minimum(lcp, cap)
        ok = ok & (lcp >= min_match_len_for_ro(ro))
        score = torch.where(ok, lcp * 1024 + (1023 - j), -1)
        better = score > best_s
        best_s = torch.maximum(best_s, score)
        best_q = torch.where(better, shift_dn(msp, j, 0), best_q)
        best_ro = torch.where(better, ro, best_ro)
        best_len = torch.where(better, lcp, best_len)
    return best_q, best_ro, best_len


def match_depth(msk, msp, rank_s, dw_s, end, depth: int, ro_cap: int = RING):
    """K1 on CUDA tensors; the plain version on CPU tensors."""
    bsz, n = msk.shape
    for name, t, shape in (("msk", msk, (bsz, n)), ("msp", msp, (bsz, n)),
                           ("rank_s", rank_s, (bsz, n)),
                           ("dw_s", dw_s, (bsz, N_DW, n)),
                           ("end", end, (bsz,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"match_depth: {name} must be int32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if not 0 < depth < 1024:  # score packs lcp*1024 + recency
        raise ValueError(f"match_depth: depth {depth} outside [1, 1023]")
    if msk.device.type == "cpu":
        return match_depth_plain(msk, msp, rank_s, dw_s, end, depth, ro_cap)
    _lib.require_cuda("match_depth", msk, msp, rank_s, dw_s, end)
    best_q = torch.empty_like(msk)
    best_ro = torch.empty_like(msk)
    best_len = torch.empty_like(msk)
    rc = _lib.library().otz_match_depth(
        msk.data_ptr(), msp.data_ptr(), rank_s.data_ptr(), dw_s.data_ptr(),
        end.data_ptr(), best_q.data_ptr(), best_ro.data_ptr(),
        best_len.data_ptr(), bsz, n, depth, ro_cap, FENCE, PAD_FRONT,
        LZ_MATCH_MIN_LEN, _FAR_GATE, FAR_RO_1, FAR_RO_2, N_DW,
        _lib.stream_ptr(msk.device),
    )
    _lib.check(rc, "otz_match_depth")
    global launches
    launches += 1
    return best_q, best_ro, best_len
