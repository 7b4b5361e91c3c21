"""The segmented scans over sorted slots (``csrc/seg_scan.cu``).

Replaces no TPU kernel: the JAX package computes these scans with
``lax.associative_scan`` and ``lax.cummax`` (``orz_tpu/ops/batched.py``,
``orz_tpu/ops/otz2.py``), and the port first rebuilt them from ATen's
``torch.cummax`` and ``torch.cumsum``, the plain versions below.  ATen
runs such a scan as one 512-thread CTA a row, so at B = 4 four SMs did
the work, at B = 1 one: about 25 ms an int64 cummax at 4 x (8 MiB + 16)
slots, 400x the 0.06 ms of the bytes.  The kernel reads a flag or a value
and writes one int32 a slot over thousands of tiles at once, carrying
each group across tiles by a decoupled look-back.

Every operator takes a (B, n) bool ``first`` (a group starts at the slot;
a row's first slot starts one whatever its flag), or ``None`` for rows
that are one group each, and returns (B, n) int32:

- ``last_marked(first, marked)``: the index of the newest marked slot at
  or before each slot within its group, -1 where there is none
  (QUALITY's ``_words1_scan_b``, MID2's ``_pred_at_items_b`` and
  ``rep0_b``; with ``marked`` the group starts, the group start of each
  slot in ``context_ranks_b`` and ``_ranks_and_membership_b``);
- ``exclusive_count(first, marked)``: the count of marked slots before
  each slot within its group (QUALITY's context counts);
- ``running_max(first, values)``: the max of the int32 values from each
  slot's group start through the slot (the item merges' ``_seg_cummax``
  and ``cand_of_queries``);
- ``exclusive_sum(first, values)``: the sum of the int32 values before
  each slot within its group, modulo 2^32 (``_expand_b``'s offsets).
"""

from __future__ import annotations

import torch

from orz_tpu_torch import trace
from orz_tpu_torch.kernels import _lib

TILE = 4096  # slots a CTA (csrc/seg_scan.cu kTile)
# the entry points' op: otz_seg_scan takes 0 and 1, otz_seg_scan_values
# 2 and 3
LAST_MARKED, EXCLUSIVE_COUNT, RUNNING_MAX, EXCLUSIVE_SUM = 0, 1, 2, 3

launches = 0  # kernel launches (not plain-version calls) since last reset


def _group_start(first: torch.Tensor) -> torch.Tensor:
    """Slot index of each slot's group start (int64)."""
    s = torch.arange(first.shape[1], device=first.device).expand_as(first)
    return torch.cummax(torch.where(first, s, 0), dim=1).values


def last_marked_plain(first: torch.Tensor | None,
                      marked: torch.Tensor) -> torch.Tensor:
    """A ``cummax`` of slot indices, clipped at the group start."""
    s = torch.arange(marked.shape[1], device=marked.device).expand_as(marked)
    last = torch.cummax(torch.where(marked, s, -1), dim=1).values
    if first is not None:
        last = torch.where(last >= _group_start(first), last, -1)
    return last.int()


def exclusive_count_plain(first: torch.Tensor | None,
                          marked: torch.Tensor) -> torch.Tensor:
    """A ``cumsum`` minus its value at the group start."""
    return exclusive_sum_plain(first, marked.int())


def running_max_plain(first: torch.Tensor | None,
                      values: torch.Tensor) -> torch.Tensor:
    """A ``cummax`` of the values; with groups, a ``cummax`` of (group id,
    value + 2^31) packed into one int64 key, minus the group's part."""
    if first is None:
        return torch.cummax(values, dim=1).values
    seg = torch.cumsum(first.long(), dim=1) << 32
    key = seg + (values.long() + (1 << 31))
    return (torch.cummax(key, dim=1).values - seg - (1 << 31)).int()


def exclusive_sum_plain(first: torch.Tensor | None,
                        values: torch.Tensor) -> torch.Tensor:
    """An int64 ``cumsum`` minus the value, minus that at the group start,
    cast to int32 (modulo 2^32, as the kernel)."""
    v = values.long()
    excl = torch.cumsum(v, dim=1) - v
    if first is not None:
        excl = excl - torch.gather(excl, 1, _group_start(first))
    return excl.int()


def check_inputs(name: str, first: torch.Tensor | None, x: torch.Tensor,
                 dtype: torch.dtype) -> None:
    bad_first = first is not None and (first.dtype != torch.bool
                                       or first.shape != x.shape)
    if x.dtype != dtype or x.dim() != 2 or bad_first:
        got = None if first is None else (first.dtype, tuple(first.shape))
        raise ValueError(f"{name}: takes a (B, n) {dtype} and a bool first "
                         f"of its shape or None, got {x.dtype} "
                         f"{tuple(x.shape)} and {got}")


def _scan(name: str, op: int, plain, first: torch.Tensor | None,
          x: torch.Tensor) -> torch.Tensor:
    valued = op in (RUNNING_MAX, EXCLUSIVE_SUM)
    check_inputs(name, first, x, torch.int32 if valued else torch.bool)
    tensors = (x,) if first is None else (first, x)
    if all(t.device.type == "cpu" for t in tensors):
        return plain(first, x)
    stream = _lib.cuda_stream(name, *tensors)
    bsz, n = x.shape
    out = torch.empty((bsz, n), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    scratch = torch.empty(1 + bsz * -(-n // TILE), dtype=torch.int64,
                          device=x.device)
    entry = (_lib.library().otz_seg_scan_values if valued
             else _lib.library().otz_seg_scan)
    rc = entry(None if first is None else first.data_ptr(), x.data_ptr(),
               out.data_ptr(), scratch.data_ptr(), bsz, n, op, stream)
    _lib.check(rc, name)
    trace.count(globals())
    return out


def last_marked(first: torch.Tensor | None,
                marked: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors; the plain version on CPU tensors."""
    return _scan("last_marked", LAST_MARKED, last_marked_plain, first,
                 marked)


def exclusive_count(first: torch.Tensor | None,
                    marked: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors; the plain version on CPU tensors."""
    return _scan("exclusive_count", EXCLUSIVE_COUNT, exclusive_count_plain,
                 first, marked)


def running_max(first: torch.Tensor | None,
                values: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors; the plain version on CPU tensors."""
    return _scan("running_max", RUNNING_MAX, running_max_plain, first,
                 values)


def exclusive_sum(first: torch.Tensor | None,
                  values: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors; the plain version on CPU tensors."""
    return _scan("exclusive_sum", EXCLUSIVE_SUM, exclusive_sum_plain, first,
                 values)
