"""Adaptive symbol-ranking transform (reference src/symrank.rs); copied for
the port from ``orz_tpu/golden/symrank.py``.

Each of the 512 contexts keeps a permutation of the 389-symbol alphabet
(value_array) together with its inverse (index_array).  Encoding maps a symbol
to its current rank; the rank of the context's "unlikely" symbol (predicted
word's first byte) is skipped by reserving the top code 388 for it
(reference src/symrank.rs:38-59).

After each coded symbol the permutation partially moves the symbol toward the
front with an adaptive step derived from a decayed running average of coded
ranks (reference src/symrank.rs:61-97).
"""

from __future__ import annotations

import numpy as np

from orz_tpu_torch.constants import SYMRANK_NUM_CONTEXTS, SYMRANK_NUM_SYMBOLS

_TOP = SYMRANK_NUM_SYMBOLS - 1  # 388: escape code for the unlikely symbol


class SymRankState:
    """State of all symbol-ranking contexts.

    n_symbols defaults to the ORZ alphabet (389); the OTZ device format uses
    the same transform over its extended 425-symbol alphabet."""

    def __init__(self, n_symbols: int = SYMRANK_NUM_SYMBOLS, n_contexts: int = SYMRANK_NUM_CONTEXTS):
        n = n_symbols
        c = n_contexts
        self.n_symbols = n_symbols
        self.top = n_symbols - 1
        self.value_array = np.zeros((c, n), dtype=np.int64)
        self.index_array = np.zeros((c, n), dtype=np.int64)
        self.cnt = np.zeros(c, dtype=np.int64)
        # 1000000: "for fast initialization" (reference src/symrank.rs:27)
        self.idx_sum = np.full(c, 1000000, dtype=np.int64)

    def init_all(self, value_array) -> None:
        """(Re)initialize every context with the same symbol order and fresh
        adaptation counters (reference src/lz.rs:258-264)."""
        va = np.asarray(value_array, dtype=np.int64)
        ia = np.zeros_like(va)
        ia[va] = np.arange(self.n_symbols, dtype=np.int64)
        self.value_array[:] = va
        self.index_array[:] = ia
        self.cnt[:] = 0
        self.idx_sum[:] = 1000000

    def _update(self, ctx: int, v: int, i: int) -> None:
        if self.cnt[ctx] > self.n_symbols:
            self.cnt[ctx] = self.cnt[ctx] * 9 // 10
            self.idx_sum[ctx] = self.idx_sum[ctx] * 9 // 10
        self.cnt[ctx] += 1
        self.idx_sum[ctx] += i

        # u16-saturating step toward the front, at most halving the rank
        step = i // 16 + ((int(self.idx_sum[ctx]) // 16 // int(self.cnt[ctx])) & 0xFFFF)
        next_i = max(max(i - step, 0), i // 2)

        va = self.value_array[ctx]
        ia = self.index_array[ctx]
        d = i - next_i
        if d == 0:
            return
        if d == 1:
            nv1 = va[next_i]
            ia[v] = next_i
            va[i] = nv1
            ia[nv1] = i
            va[next_i] = v
        else:
            ni2 = next_i
            ni1 = next_i + d // 2
            nv1 = va[ni1]
            nv2 = va[ni2]
            va[i] = nv1
            ia[nv1] = i
            va[ni1] = nv2
            ia[nv2] = ni1
            va[ni2] = v
            ia[v] = ni2

    def encode(self, ctx: int, v: int, vunlikely: int) -> int:
        ia = self.index_array[ctx]
        i = int(ia[v])
        iunlikely = int(ia[vunlikely])
        self._update(ctx, v, i)
        if i == iunlikely:
            return self.top
        return i - (1 if i > iunlikely else 0)

    def decode(self, ctx: int, i: int, vunlikely: int) -> int:
        iunlikely = int(self.index_array[ctx][vunlikely])
        if i == self.top:
            i = iunlikely
        else:
            i = i + (0 if i < iunlikely else 1)
        v = int(self.value_array[ctx][i])
        self._update(ctx, v, i)
        return v
