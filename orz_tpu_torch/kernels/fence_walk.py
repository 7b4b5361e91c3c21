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

from orz_tpu_torch import trace
from orz_tpu_torch.kernels import _lib
from orz_tpu_torch.spec import FENCE, PAD_FRONT

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


def check_inputs(name: str, nxt: torch.Tensor, seg_lens: torch.Tensor):
    if nxt.dtype != torch.int32 or seg_lens.dtype != torch.int32 \
            or nxt.dim() != 2 or tuple(seg_lens.shape) != (nxt.shape[0],):
        raise ValueError(f"{name}: nxt (B, n) and seg_lens (B,) must be "
                         "int32")


def launch_walk(name: str, nxt: torch.Tensor, seg_lens: torch.Tensor,
                counts: bool = False):
    """Run the walk kernel on CUDA tensors; returns the start mask (every
    byte written by the kernel) and the (B,) int32 item counts that the
    kernel adds up (None without ``counts``).  Shared by K3 and K4
    (``kernels/walk_mask.py``), which count their own launches."""
    bsz, n = nxt.shape
    if n <= PAD_FRONT:
        raise ValueError(f"{name}: n = {n} leaves no block after the "
                         f"{PAD_FRONT}-position head")
    end = (PAD_FRONT + seg_lens).int()
    stream = _lib.cuda_stream(name, nxt, end)
    mask = torch.empty((bsz, n), dtype=torch.bool, device=nxt.device)
    n_items = torch.zeros(bsz, dtype=torch.int32, device=nxt.device) \
        if counts else None
    n_blocks = -(-(n - PAD_FRONT) // FENCE)
    rc = _lib.library().otz_fence_walk(
        nxt.data_ptr(), end.data_ptr(), mask.data_ptr(),
        n_items.data_ptr() if counts else None, bsz, n, n_blocks, FENCE,
        PAD_FRONT, stream,
    )
    _lib.check(rc, name)
    return mask, n_items


def fence_walk_mask(nxt: torch.Tensor, seg_lens: torch.Tensor):
    """K3 on CUDA tensors; the plain walk on CPU tensors."""
    check_inputs("fence_walk", nxt, seg_lens)
    if nxt.device.type == "cpu":
        return fence_walk_mask_plain(nxt, seg_lens)
    mask, _ = launch_walk("fence_walk", nxt, seg_lens)
    trace.count(globals())
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
