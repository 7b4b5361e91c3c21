"""Length-limited optimal Huffman code lengths via boundary package-merge.

The reference builds a Huffman tree with a heap and, when the depth exceeds
15, halves all weights and rebuilds (reference src/huffman.rs:27-111) — a
sequential, data-dependent loop.  Package-merge (Larmore & Hirschberg) gives
*optimal* 15-bit-limited lengths as 15 rounds of sort+merge over ~2n items —
fully vectorizable, so the numpy reference here and the batched torch twin
(``ops/huffman.py`` ``pm_code_lens_b``) run the same algorithm and must
produce identical lengths (ties are fixed by a stable sort with leaves
listed before packages).

Boundary counting form: only item VALUES and a per-level count of leading
leaves are needed.  Walking levels top-down with t_L = 2n'-2 items taken,
k_l = leaves among the first t_l, t_{l-1} = 2 (t_l - k_l); the code length
of the rank-r leaf is #{l : r < k_l}.

The resulting lengths satisfy Kraft equality, so the canonical code
assignment (reference src/huffman.rs:118-141) applies unchanged.

A copy of ``orz_tpu/device/pm_huffman.py``, pinned to it by
``tests/test_torch_refcodec.py``.
"""

from __future__ import annotations

import numpy as np

from orz_tpu_torch.constants import HUFFMAN_MAX_CODE_LEN

INF = np.int64(1) << 40


def pm_code_lens(weights, max_len: int = HUFFMAN_MAX_CODE_LEN) -> np.ndarray:
    """weights -> optimal code lengths with max(lens) <= max_len.

    Zero-weight symbols get length 0.  Deterministic across
    implementations: each level stable-sorts [leaves ++ packages] by value.
    """
    w = np.asarray(weights, dtype=np.int64)
    n = len(w)
    lens = np.zeros(n, dtype=np.int64)
    active = w > 0
    n_active = int(active.sum())
    if n_active == 0:
        return lens
    if n_active == 1:
        lens[np.argmax(active)] = 1
        return lens
    assert (1 << max_len) >= n_active

    leaf_vals = np.where(active, w, INF)
    order = np.lexsort((np.arange(n), leaf_vals))  # by (weight, symbol)
    leaf_sorted = leaf_vals[order]

    m = 2 * n
    vals = np.concatenate([leaf_sorted, np.full(n, INF, dtype=np.int64)])
    is_leaf = np.concatenate([np.ones(n, bool), np.zeros(n, bool)])
    # leaf_prefix[l][x] = leaves among the first x items of level-l list
    leaf_prefixes = [np.cumsum(is_leaf)]

    for _ in range(max_len - 1):
        pk_vals = np.minimum(vals[0::2] + vals[1::2], INF)
        merged_vals = np.concatenate([leaf_sorted, pk_vals])
        merged_leaf = np.concatenate([np.ones(n, bool), np.zeros(n, bool)])
        perm = np.argsort(merged_vals, kind="stable")
        vals = merged_vals[perm]
        is_leaf = merged_leaf[perm]
        leaf_prefixes.append(np.cumsum(is_leaf))

    # backward pass: items taken per level -> leading leaves taken
    t = 2 * n_active - 2
    ranks = np.arange(n, dtype=np.int64)
    per_rank = np.zeros(n, dtype=np.int64)
    for l in range(max_len - 1, -1, -1):  # leaf_prefixes[l] is level l+1
        k = int(leaf_prefixes[l][t - 1]) if t > 0 else 0
        per_rank += ranks < k
        t = 2 * (t - k)

    lens[order[:n_active]] = per_rank[:n_active]
    return lens
