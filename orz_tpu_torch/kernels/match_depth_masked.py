"""K2: the masked candidate depth loop (``csrc/match_depth.cu``).

Replaces ``orz_tpu/ops/match_pallas.py`` ``match_depth_pallas`` with a
``mask_s`` (``_make_kernel(masked=True)``), the OTZ2 iteration and conform
analyses' search: candidates only at mask-1 slots (the previous parse's
item starts), ``rank_s`` holding masked prefix counts, offsets gated at
``ro_cap``; past ``near_depth`` (when > 0) only mask-1 queries look; with
``ro_cap_near < ro_cap`` the far tier scores its LCP alone.  Inputs as K1's
(``kernels/match_depth.py``) plus ``mask_s`` (B, n) bool in sorted order,
its storage 4-byte aligned (the kernel stages it in 4-byte words).
"""

from __future__ import annotations

import torch

from orz_tpu_torch import trace
from orz_tpu_torch.device.host import N_DW
from orz_tpu_torch.kernels import _lib
from orz_tpu_torch.kernels.match_depth import (
    check_inputs,
    match_depth_plain,
)
from orz_tpu_torch.spec import (
    FAR_RO_1,
    FAR_RO_2,
    FENCE,
    LZ_MATCH_MIN_LEN,
    PAD_FRONT,
    _FAR_GATE,
)

launches = 0  # kernel launches (not plain-version calls) since last reset


def match_depth_masked(msk, msp, rank_s, dw_s, end, mask_s, depth: int,
                       ro_cap: int, near_depth: int = 0,
                       ro_cap_near: int | None = None):
    """K2 on CUDA tensors; the plain version on CPU tensors."""
    check_inputs("match_depth_masked", msk, msp, rank_s, dw_s, end, depth)
    if mask_s.dtype != torch.bool or mask_s.shape != msk.shape:
        raise ValueError("match_depth_masked: mask_s must be bool (B, n)")
    if mask_s.data_ptr() % 4:
        raise ValueError("match_depth_masked: mask_s's storage must be "
                         "4-byte aligned")
    if msk.device.type == "cpu":
        return match_depth_plain(msk, msp, rank_s, dw_s, end, depth, ro_cap,
                                 mask_s, near_depth, ro_cap_near)
    stream = _lib.cuda_stream("match_depth_masked", msk, msp, rank_s, dw_s,
                              end, mask_s)
    bsz, n = msk.shape
    out = tuple(torch.empty_like(msk) for _ in range(3))
    near_cap = ro_cap if ro_cap_near is None else min(ro_cap_near, ro_cap)
    rc = _lib.library().otz_match_depth_masked(
        msk.data_ptr(), msp.data_ptr(), rank_s.data_ptr(), dw_s.data_ptr(),
        mask_s.data_ptr(), end.data_ptr(), *(t.data_ptr() for t in out), bsz,
        n, depth, ro_cap, near_depth, near_cap, FENCE, PAD_FRONT,
        LZ_MATCH_MIN_LEN, _FAR_GATE, FAR_RO_1, FAR_RO_2, N_DW, stream,
    )
    _lib.check(rc, "match_depth_masked")
    trace.count(globals())
    return out
