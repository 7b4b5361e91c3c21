"""P1: the windowed gather (``csrc/windowed_gather.cu``).

Replaces ``tools/gather_probe.py`` ``windowed_gather``, the probe's Pallas
kernel: ``src`` int32 ``(n,)`` with n a multiple of 128 and n >= WIN,
``idx`` int32 ``(m,)`` with m a positive multiple of BLK, ``base`` int32
``(m / BLK,)``; the output is int32 ``(m,)``.  Output block b reads the
WIN-word window of ``src`` that starts at row ``base[b] // 128`` (clamped
to end inside ``src``); an index is taken relative to the unclamped row,
wraps by +WIN when it lies less than WIN below it, and reads 0 past the
window.  For ascending indices whose block spans less than WIN from its
aligned base, the caller's contract, that is ``src[idx]``.
"""

from __future__ import annotations

import torch

from orz_tpu_torch import trace
from orz_tpu_torch.kernels import _lib

BLK = 2048  # outputs per block (tools/gather_probe.py)
WIN = 4 * BLK  # source window per block

launches = 0  # kernel launches (not plain-version calls) since last reset


def windowed_gather_plain(src: torch.Tensor, idx: torch.Tensor,
                          base: torch.Tensor) -> torch.Tensor:
    """The same function in plain torch ops."""
    n = src.shape[0]
    row0 = torch.div(base, 128, rounding_mode="floor").view(-1, 1)
    start = row0.clamp(0, n // 128 - WIN // 128) * 128
    rel = idx.view(-1, BLK) - row0 * 128
    rel = torch.where((rel < 0) & (rel >= -WIN), rel + WIN, rel)
    inside = (rel >= 0) & (rel < WIN)
    words = src[(start + rel.clamp(0, WIN - 1)).long()]
    return torch.where(inside, words, 0).view(-1)


def check_inputs(src: torch.Tensor, idx: torch.Tensor,
                 base: torch.Tensor) -> None:
    for arg, t in (("src", src), ("idx", idx), ("base", base)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"windowed_gather: {arg} must be 1-D int32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    n, m = src.shape[0], idx.shape[0]
    if n % 128 or n < WIN:
        raise ValueError(f"windowed_gather: src length {n} must be a "
                         f"multiple of 128 and at least {WIN}")
    if m % BLK or m == 0:
        raise ValueError(f"windowed_gather: idx length {m} must be a "
                         f"positive multiple of {BLK}")
    if base.shape[0] != m // BLK:
        raise ValueError(f"windowed_gather: base must have {m // BLK} "
                         f"entries, got {base.shape[0]}")


def windowed_gather(src: torch.Tensor, idx: torch.Tensor,
                    base: torch.Tensor) -> torch.Tensor:
    """P1 on CUDA tensors; the plain version on CPU tensors."""
    check_inputs(src, idx, base)
    if src.device.type == "cpu":
        return windowed_gather_plain(src, idx, base)
    stream = _lib.cuda_stream("windowed_gather", src, idx, base)
    out = torch.empty_like(idx)
    rc = _lib.library().otz_windowed_gather(
        src.data_ptr(), idx.data_ptr(), base.data_ptr(), out.data_ptr(),
        src.shape[0], idx.shape[0] // BLK, stream)
    _lib.check(rc, "windowed_gather")
    trace.count(globals())
    return out
