"""K3: the fence-block item walk (``csrc/fence_walk.cu``).

Replaces ``orz_tpu/ops/walk_pallas.py`` ``walk_items_pallas``.  Given the
per-position ``nxt`` (B, n) int32 of the parse decisions, returns
``(starts, n_items, mask)``: the item starts per segment in stream order
(``(B, n - PAD_FRONT)`` int32, tail filled with the segment end, as
``orz_tpu/ops/batched.py`` ``walk_items_b`` fills it), their count, and
the ``(B, n)`` bool item-start mask.
"""

from __future__ import annotations

import torch

from orz_tpu.device.spec import FENCE, PAD_FRONT
from orz_tpu_torch.kernels import _lib

launches = 0  # kernel launches (not plain-version calls) since last reset

WALK_CHUNK = 256  # steps between the plain walk's all-done checks


def fence_walk_mask_plain(nxt: torch.Tensor, seg_lens: torch.Tensor):
    """``walk_items_b``'s lockstep walk: all blocks of all segments advance
    one gather step at a time; returns the item-start mask."""
    bsz, n = nxt.shape
    n_blocks = -(-(n - PAD_FRONT) // FENCE)
    end = (PAD_FRONT + seg_lens.long()).view(-1, 1)
    base = (PAD_FRONT + FENCE * torch.arange(n_blocks, device=nxt.device)
            ).expand(bsz, n_blocks)
    blk_end = torch.minimum(base + FENCE, end)
    mask = torch.zeros((bsz, n + 1), dtype=torch.bool, device=nxt.device)
    cur = base.clone()
    for step in range(FENCE):
        active = cur < blk_end
        if step % WALK_CHUNK == 0 and not bool(active.any()):
            break
        mask.scatter_(1, torch.where(active, cur, n), True)
        nxtv = torch.gather(nxt, 1, cur.clamp(0, n - 1)).long()
        cur = torch.where(active, nxtv, cur)
    return mask[:, :n].contiguous()


def fence_walk_mask(nxt: torch.Tensor, seg_lens: torch.Tensor):
    """K3 on CUDA tensors; the plain walk on CPU tensors."""
    bsz, n = nxt.shape
    if nxt.dtype != torch.int32 or seg_lens.dtype != torch.int32 \
            or tuple(seg_lens.shape) != (bsz,):
        raise ValueError("fence_walk: nxt (B, n) and seg_lens (B,) must be "
                         "int32")
    if nxt.device.type == "cpu":
        return fence_walk_mask_plain(nxt, seg_lens)
    end = (PAD_FRONT + seg_lens).int()
    _lib.require_cuda("fence_walk", nxt, end)
    mask = torch.zeros((bsz, n), dtype=torch.bool, device=nxt.device)
    n_blocks = -(-(n - PAD_FRONT) // FENCE)
    rc = _lib.library().otz_fence_walk(
        nxt.data_ptr(), end.data_ptr(), mask.data_ptr(), bsz, n, n_blocks,
        FENCE, PAD_FRONT, _lib.stream_ptr(nxt.device),
    )
    _lib.check(rc, "otz_fence_walk")
    global launches
    launches += 1
    return mask


def starts_from_mask(mask: torch.Tensor, seg_lens: torch.Tensor):
    """(starts, n_items): the mask's positions compacted in position order,
    the tail filled with the segment end (one scatter, no sort)."""
    bsz, n = mask.shape
    m = n - PAD_FRONT
    end = (PAD_FRONT + seg_lens.long()).view(-1, 1)
    n_items = mask.sum(dim=1).int()
    slot = torch.cumsum(mask.int(), dim=1) - 1
    slot = torch.where(mask, slot, m)  # non-starts go to the dropped column
    pos = torch.arange(n, device=mask.device).expand(bsz, n)
    starts = end.expand(bsz, m + 1).clone()
    starts.scatter_(1, slot, pos)
    return starts[:, :m].int(), n_items


def walk_items(nxt: torch.Tensor, seg_lens: torch.Tensor):
    """(starts, n_items, mask) as ``walk_items_pallas`` returns them."""
    mask = fence_walk_mask(nxt, seg_lens)
    starts, n_items = starts_from_mask(mask, seg_lens)
    return starts, n_items, mask
