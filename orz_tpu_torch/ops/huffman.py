"""Batched package-merge code lengths and canonical codes, in torch.

Row-batched twins of ``orz_tpu/ops/huffman.py`` ``pm_code_lens`` and
``canonical_codes`` (which the JAX package vmaps): the same boundary
package-merge, the same stable tie-breaking, so every row's lengths equal
the JAX (and host ``device/pm_huffman.py``) lengths.
"""

from __future__ import annotations

import torch

from orz_tpu_torch.spec import HUFFMAN_MAX_CODE_LEN

INF = 1 << 28  # weights are < 2^21; INF+INF stays < 2^31


def pm_code_lens_b(w: torch.Tensor,
                   max_len: int = HUFFMAN_MAX_CODE_LEN) -> torch.Tensor:
    """Optimal max_len-limited code lengths, one row of weights (R, n) at a
    time; returns (R, n) int64."""
    rows, n = w.shape
    dev = w.device
    w = w.long()
    active = w > 0
    n_active = active.sum(dim=1)

    leaf_sorted, order = torch.sort(torch.where(active, w, INF), dim=1,
                                    stable=True)
    leaf_flag = torch.cat([torch.ones(n, dtype=torch.int64, device=dev),
                           torch.zeros(n, dtype=torch.int64, device=dev)])
    vals = torch.cat([leaf_sorted, torch.full_like(leaf_sorted, INF)], dim=1)
    leaf_prefixes = [torch.cumsum(leaf_flag, 0).expand(rows, 2 * n)]
    for _ in range(max_len - 1):
        pk_vals = torch.clamp(vals[:, 0::2] + vals[:, 1::2], max=INF)
        vals, o = torch.sort(torch.cat([leaf_sorted, pk_vals], dim=1), dim=1,
                             stable=True)
        leaf_prefixes.append(torch.cumsum(leaf_flag[o], dim=1))

    t = 2 * n_active - 2
    ranks = torch.arange(n, device=dev).expand(rows, n)
    per_rank = torch.zeros((rows, n), dtype=torch.int64, device=dev)
    for lvl in range(max_len - 1, -1, -1):
        at = (t - 1).clamp(0, 2 * n - 1).view(-1, 1)
        k = torch.where(t > 0, torch.gather(leaf_prefixes[lvl], 1, at)[:, 0],
                        0)
        per_rank = per_rank + (ranks < k.view(-1, 1)).long()
        t = 2 * (t - k)

    na = n_active.view(-1, 1)
    lens = torch.zeros_like(per_rank).scatter_(
        1, order, torch.where(ranks < na, per_rank, 0))
    lens = torch.where(na == 1, active.long(), lens)
    return torch.where(na == 0, 0, lens)


def canonical_codes_b(lens: torch.Tensor) -> torch.Tensor:
    """codes[row, sym], canonical by (len, sym) (reference
    src/huffman.rs:118-141); returns (R, n) int64."""
    rows, n = lens.shape
    lens = lens.long()
    count_per_len = torch.zeros((rows, HUFFMAN_MAX_CODE_LEN + 1),
                                dtype=torch.int64, device=lens.device)
    count_per_len.scatter_add_(1, lens, (lens > 0).long())
    codes = torch.zeros_like(lens)
    next_code = torch.zeros((rows, 1), dtype=torch.int64, device=lens.device)
    for lvl in range(1, HUFFMAN_MAX_CODE_LEN + 1):
        mask = lens == lvl
        rank = torch.cumsum(mask.long(), dim=1) - 1
        codes = torch.where(mask, next_code + rank, codes)
        next_code = (next_code + count_per_len[:, lvl : lvl + 1]) << 1
    return codes
