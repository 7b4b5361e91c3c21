"""K4: the fence-block walk's mask and item count, for the QUALITY scan.

Replaces ``orz_tpu/ops/walk_pallas.py`` ``walk_mask_pallas``
(``_mask_kernel``): given the parse's ``nxt`` (B, n) int32, returns the
(B, n) bool item-start mask in position order and the (B,) int32 item
counts, with no start compaction.  It launches the same CUDA entry point
as K3 (``csrc/fence_walk.cu``), whose kernel writes exactly this mask and
adds up the counts.
"""

from __future__ import annotations

import torch

from orz_tpu_torch import trace
from orz_tpu_torch.kernels import _lib
from orz_tpu_torch.kernels.fence_walk import (
    check_inputs,
    fence_walk_mask_plain,
    launch_walk,
)

launches = 0  # kernel launches (not plain-version calls) since last reset


def walk_mask_plain(nxt: torch.Tensor, seg_lens: torch.Tensor):
    mask = fence_walk_mask_plain(nxt, seg_lens)
    return mask, mask.sum(dim=1).int()


def walk_mask(nxt: torch.Tensor, seg_lens: torch.Tensor):
    """(mask, n_items): K4 on CUDA tensors; the plain walk on CPU tensors."""
    check_inputs("walk_mask", nxt, seg_lens)
    if nxt.device.type == "cpu":
        return walk_mask_plain(nxt, seg_lens)
    out = launch_walk("walk_mask", nxt, seg_lens, counts=True)
    trace.count(globals())
    return out
