"""The segmented scans over sorted slots (``csrc/seg_scan.cu``).

Replaces no TPU kernel: the JAX package computes these scans with
``lax.associative_scan`` in ``_words1_scan_b`` and
``masked_context_counts_planned_b`` (``orz_tpu/ops/batched.py``) and in
``_pred_at_items_b`` (``orz_tpu/ops/otz2.py``), and the port first rebuilt
them from ATen's int64 ``torch.cummax`` and ``torch.cumsum``, the plain
versions below.  ATen runs such a scan as one 512-thread CTA a row, so at
B = 4 four SMs did QUALITY's scans: about 25 ms an int64 cummax at
4 x (8 MiB + 16) slots, 400x the 0.06 ms of the bytes.
The kernel reads two bool flags and writes one int32 a slot (bound: 6
bytes a slot over 3.35 TB/s) over thousands of tiles at once, carrying
each group across tiles by a decoupled look-back.

Both operators take (B, n) bool ``first`` (a group starts at the slot; a
row's first slot starts one whatever its flag) and ``marked``, and return
(B, n) int32:

- ``last_marked``: the index of the newest marked slot at or before each
  slot within its group, -1 where there is none;
- ``exclusive_count``: the count of marked slots before each slot within
  its group.
"""

from __future__ import annotations

import torch

from orz_tpu_torch import trace
from orz_tpu_torch.kernels import _lib

TILE = 4096  # slots a CTA (csrc/seg_scan.cu kTile)
LAST_MARKED, EXCLUSIVE_COUNT = 0, 1  # the entry point's op

launches = 0  # kernel launches (not plain-version calls) since last reset


def _group_start(first: torch.Tensor) -> torch.Tensor:
    """Slot index of each slot's group start (int64)."""
    s = torch.arange(first.shape[1], device=first.device).expand_as(first)
    return torch.cummax(torch.where(first, s, 0), dim=1).values


def last_marked_plain(first: torch.Tensor,
                      marked: torch.Tensor) -> torch.Tensor:
    """A ``cummax`` of slot indices, clipped at the group start."""
    s = torch.arange(first.shape[1], device=first.device).expand_as(first)
    last = torch.cummax(torch.where(marked, s, -1), dim=1).values
    return torch.where(last >= _group_start(first), last, -1).int()


def exclusive_count_plain(first: torch.Tensor,
                          marked: torch.Tensor) -> torch.Tensor:
    """A ``cumsum`` minus its value at the group start."""
    sm = marked.long()
    excl = torch.cumsum(sm, dim=1) - sm
    return (excl - torch.gather(excl, 1, _group_start(first))).int()


def check_inputs(name: str, first: torch.Tensor,
                 marked: torch.Tensor) -> None:
    if first.dtype != torch.bool or marked.dtype != torch.bool \
            or first.dim() != 2 or first.shape != marked.shape:
        raise ValueError(f"{name}: first and marked must be (B, n) bool of "
                         f"one shape, got {first.dtype} "
                         f"{tuple(first.shape)} and {marked.dtype} "
                         f"{tuple(marked.shape)}")


def _scan(name: str, op: int, plain, first: torch.Tensor,
          marked: torch.Tensor) -> torch.Tensor:
    check_inputs(name, first, marked)
    if first.device.type == "cpu" and marked.device.type == "cpu":
        return plain(first, marked)
    stream = _lib.cuda_stream(name, first, marked)
    bsz, n = first.shape
    out = torch.empty((bsz, n), dtype=torch.int32, device=first.device)
    if out.numel() == 0:
        return out
    scratch = torch.empty(1 + bsz * -(-n // TILE), dtype=torch.int64,
                          device=first.device)
    rc = _lib.library().otz_seg_scan(
        first.data_ptr(), marked.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), bsz, n, op, stream)
    _lib.check(rc, name)
    trace.count(globals())
    return out


def last_marked(first: torch.Tensor, marked: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors; the plain version on CPU tensors."""
    return _scan("last_marked", LAST_MARKED, last_marked_plain, first,
                 marked)


def exclusive_count(first: torch.Tensor,
                    marked: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors; the plain version on CPU tensors."""
    return _scan("exclusive_count", EXCLUSIVE_COUNT, exclusive_count_plain,
                 first, marked)
