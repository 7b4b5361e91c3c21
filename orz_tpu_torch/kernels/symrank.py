"""K5: the symbol-ranking transform (``csrc/symrank.cu``).

Replaces ``orz_tpu/ops/symrank_pallas.py`` ``_phase_call`` as driven by
``orz_tpu/ops/batched.py`` ``symrank_pallas_b``: per segment, items are
grouped by context with a stable sort (as ``symrank_pallas_b`` groups them
into rounds), and each (segment, context) walks its items in item order.
There are no round buckets; the encoders mirror JAX's skew check against
``R_CAP_MAX`` all the same (``device/batch.py``, ``device/pipeline.py``),
so that a skewed segment takes JAX's route.

Inputs ``symbol``, ``sr_unlikely``, ``sr_ctx`` (B, m), ``n_items`` (B,),
``init_perm`` (B, S) (the census order); output ``coded`` (B, m) int32,
with 0 past ``n_items``.
"""

from __future__ import annotations

import torch

from orz_tpu_torch import trace
from orz_tpu_torch.device.host import C, S, S_PAD, TOP
from orz_tpu_torch.kernels import _lib

launches = 0  # kernel launches (not plain-version calls) since last reset


def symrank_plain(symbol, sr_unlikely, sr_ctx, n_items, init_perm):
    """Item-by-item transcription of ``golden/symrank.SymRankState``
    (value and index arrays per context), on host lists."""
    bsz, m = symbol.shape
    coded = torch.zeros((bsz, m), dtype=torch.int32)
    for b in range(bsz):
        ni = int(n_items[b])
        syms = symbol[b, :ni].tolist()
        unls = sr_unlikely[b, :ni].tolist()
        ctxs = sr_ctx[b, :ni].tolist()
        perm = [int(v) for v in init_perm[b].tolist()]
        inv = [0] * S
        for r, v in enumerate(perm):
            inv[v] = r
        state = {}  # ctx -> [va, ia, cnt, isum]
        out = [0] * ni
        for k in range(ni):
            st = state.get(ctxs[k])
            if st is None:
                st = state[ctxs[k]] = [list(perm), list(inv), 0, 1000000]
            va, ia = st[0], st[1]
            v = syms[k]
            i = ia[v]
            iu = ia[unls[k]]
            out[k] = TOP if i == iu else i - (1 if i > iu else 0)
            if st[2] > S:
                st[2] = st[2] * 9 // 10
                st[3] = st[3] * 9 // 10
            st[2] += 1
            st[3] += i
            step = i // 16 + ((st[3] // 16 // st[2]) & 0xFFFF)
            next_i = max(max(i - step, 0), i // 2)
            d = i - next_i
            if d == 0:
                continue
            ni1 = i if d == 1 else next_i + d // 2
            nv2 = va[next_i]
            nv1 = nv2 if d == 1 else va[ni1]
            va[i] = nv1
            ia[nv1] = i
            va[ni1] = nv2
            ia[nv2] = ni1
            va[next_i] = v
            ia[v] = next_i
        coded[b, :ni] = torch.tensor(out, dtype=torch.int32)
    return coded.to(symbol.device)


def symrank(symbol, sr_unlikely, sr_ctx, n_items, init_perm):
    """K5 on CUDA tensors; the plain version on CPU tensors."""
    bsz, m = symbol.shape
    if tuple(init_perm.shape) != (bsz, S) or tuple(n_items.shape) != (bsz,):
        raise ValueError("symrank: init_perm must be (B, S), n_items (B,)")
    if symbol.device.type == "cpu":
        return symrank_plain(symbol, sr_unlikely, sr_ctx, n_items, init_perm)
    dev = symbol.device
    idx = torch.arange(m, device=dev).expand(bsz, m)
    valid = idx < n_items.view(-1, 1)
    ctx = torch.where(valid, sr_ctx.long(), C)
    _, item_of = torch.sort(ctx, dim=1, stable=True)  # (ctx, idx) order
    cnt = torch.zeros((bsz, C + 1), dtype=torch.int64, device=dev)
    cnt.scatter_add_(1, ctx, torch.ones_like(ctx))
    cnt = cnt[:, :C]
    off = torch.cumsum(cnt, dim=1) - cnt
    pack = symbol.long() | (sr_unlikely.long() << 9)
    packed = torch.gather(pack, 1, item_of).int().contiguous()
    item_of = item_of.int().contiguous()
    off = off.int().contiguous()
    cnt = cnt.int().contiguous()
    perm = init_perm.int().contiguous()
    coded = torch.zeros((bsz, m), dtype=torch.int32, device=dev)
    stream = _lib.cuda_stream("symrank", packed, item_of, off, cnt, perm,
                              coded)
    rc = _lib.library().otz_symrank(
        packed.data_ptr(), item_of.data_ptr(), off.data_ptr(),
        cnt.data_ptr(), perm.data_ptr(), coded.data_ptr(), bsz, m, C, S,
        S_PAD, stream,
    )
    _lib.check(rc, "otz_symrank")
    trace.count(globals())
    return coded
