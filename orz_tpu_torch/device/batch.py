"""Batched OTZ1 device encode in torch: B same-bucket segments per call.

Mirrors ``orz_tpu/device/batch.py`` ``encode_segments_batch`` for
``rings_mode=0`` (levels 0 and 1, and level 2 with ``OTZ2=0``): FRONT
(analysis, parse, fence walk) -> one host sync for the item bucket -> MID
(item fields) -> BACK (census, symrank, entropy, packing) -> one fetch of
meta and payload words -> host stream assembly.  Payloads are
byte-identical to the JAX chain's.
"""

from __future__ import annotations

import numpy as np
import torch

from orz_tpu.device.spec import (
    CHUNK_INPUT_DEFAULT,
    candidate_depth,
    n_chunks_for,
    otz2_enabled,
)
from orz_tpu.golden.bitio import BitEncoder
from orz_tpu_torch.device.host import (
    _FETCH_GRANULE,
    _bucket,
    _bucket_capacity,
    assemble_segment_np,
    pad_batch,
)
from orz_tpu_torch.ops.batched import back_body_b, front_body_b, mid_body_b


def _empty_payload(chunk_input: int) -> bytes:
    enc = BitEncoder()
    enc.encode_varint(0)
    enc.encode_varint(chunk_input)
    return enc.finish()


def encode_segments_batch(
    datas: list[bytes],
    level: int = 1,
    chunk_input: int = CHUNK_INPUT_DEFAULT,
    rings_mode: int | None = None,
    cap: int | None = None,
    device: str | torch.device = "cuda",
) -> list[bytes]:
    """Encode B segments through the batched OTZ1 chain on `device`;
    returns the payloads in order.  All segments share one `cap` bucket
    (default: the bucket of the largest)."""
    if not datas or any(d is None for d in datas):
        raise ValueError("encode_segments_batch needs a list of bytes")
    if rings_mode is None:
        rings_mode = int(otz2_enabled(level))
    if rings_mode:
        raise NotImplementedError(
            "rings_mode=1 (OTZ2 item-start rings, the l2 default) is the l2 "
            "slice of the port (QUALITY + MID2), not ported yet; pass "
            "rings_mode=0 or set OTZ2=0")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("encode_segments_batch: CUDA device requested "
                           "but torch.cuda.is_available() is false")
    if any(len(d) == 0 for d in datas):  # empty segments: host-only framing
        full = [d for d in datas if d]
        enc = iter(encode_segments_batch(full, level, chunk_input, 0, cap,
                                         device) if full else [])
        return [next(enc) if d else _empty_payload(chunk_input)
                for d in datas]
    if cap is None:
        cap = _bucket_capacity(max(len(d) for d in datas))
    c_max = n_chunks_for(cap, chunk_input)
    bufs_np, lens_np = pad_batch(datas, cap)
    bufs = torch.from_numpy(bufs_np).to(device)
    seg_lens = torch.from_numpy(lens_np).to(device)

    starts, n_items, pk1, bestq, bestro, bufs, _mask = front_body_b(
        bufs, seg_lens, candidate_depth(level))
    ni_max = int(n_items.max())
    m_cap = _bucket(max(ni_max, 1), 1 << 14, 2)
    items, _r1, _rounds = mid_body_b(starts, n_items, pk1, bestq, bestro,
                                     bufs, seg_lens, m_cap)
    del starts, pk1, bestq, bestro, _mask
    out = back_body_b(items, chunk_input, c_max)
    del items

    metas = out.meta.cpu().numpy()
    total_words = int(metas[:, 3].max())
    k_fetch = min(out.words.shape[1],
                  -(-max(total_words, 1) // _FETCH_GRANULE) * _FETCH_GRANULE)
    words = out.words[:, :k_fetch].cpu().numpy().astype(np.uint32)

    payloads = []
    for b, data in enumerate(datas):
        enc = BitEncoder()
        enc.encode_varint(len(data))
        enc.encode_varint(chunk_input)
        payloads.append(assemble_segment_np(enc, metas[b], words[b],
                                            len(data), chunk_input,
                                            rings_mode=0))
    return payloads
