"""Block-data-parallel segment encoding over CUDA devices:
``orz_tpu/parallel/mesh.py`` in torch.

A mesh is a tuple of ``torch.device``s, the "blocks" axis.  A batch of B
segments splits into contiguous blocks of B / len(mesh) segments, one per
device, as JAX's ``P("blocks")`` splits it, and each device runs the
encode chain on its block from its own host thread.  Segments are
independent, so nothing crosses devices but the payloads, which come back
to the host for assembly.

- ``mesh_encode_segments_staged``: the default l2 (OTZ2) chain, the bodies
  of ``device/batch.py`` with JAX's static symrank caps (``_sr_caps_for``).
  A segment whose repair failed or whose rounds pass those caps is flagged
  and re-encoded through the staged encoder at rings_mode 1, JAX's rule
  (not the batched chain's OTZ1 fallback).  MID2's item cap is the batch
  chain's bucket where it is smaller than JAX's ``m2_cap=cap``; a segment
  that reached the bucket in either emission is emitted again at ``cap``,
  so that each payload is JAX's.
- ``batched_encode`` and ``mesh_encode_segments``: JAX's monolithic OTZ1
  program at the level's depth, here the OTZ1 chain over each block.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from orz_tpu_torch.device.batch import (
    assemble,
    fetch_out,
    m2_cap_for,
    mid2_body,
    quality_scan_body,
    quality_split,
    quality_tail_body,
    resolve_device,
    without_failed,
)
from orz_tpu_torch.device.host import (
    SegmentOut,
    _bucket,
    _bucket_capacity,
    pad_batch,
)
from orz_tpu_torch.device.pipeline import empty_payload, encode_segment_staged
from orz_tpu_torch.ops.batched import back_body_b, front_body_b, mid_body_b
from orz_tpu_torch.spec import (
    CHUNK_INPUT_DEFAULT,
    candidate_depth,
    n_chunks_for,
    otz2_schedule,
)

Mesh = Sequence[torch.device]


def blocks_mesh(n_devices: Optional[int] = None) -> tuple:
    """The first `n_devices` CUDA devices (default: every visible one)."""
    if not torch.cuda.is_available():
        raise RuntimeError("blocks_mesh: torch.cuda.is_available() is false;"
                           " pass a mesh of CPU devices to run on the CPU")
    count = torch.cuda.device_count()
    n = n_devices or count
    if n > count:
        raise ValueError(f"blocks_mesh: {n} devices asked, {count} visible")
    return tuple(torch.device("cuda", i) for i in range(n))


def _blocks(n: int, mesh: Mesh) -> list:
    """Each device's contiguous block of a batch of n, as P("blocks")."""
    assert n % len(mesh) == 0, "batch must tile the mesh"
    per = n // len(mesh)
    return [range(k * per, (k + 1) * per) for k in range(len(mesh))]


def _on_mesh(mesh: Mesh, fn, blocks) -> list:
    """fn(device, block) for every device, each on its own host thread
    (with that device current); the results in mesh order."""
    def run(dev, block):
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return fn(dev, block)
        return fn(dev, block)

    with ThreadPoolExecutor(max_workers=len(mesh)) as pool:
        futs = [pool.submit(run, d, b) for d, b in zip(mesh, blocks)]
        return [f.result() for f in futs]


def _otz1_local(bufs, seg_lens, depth: int, chunk_input: int, c_max: int):
    """FRONT, OTZ1 MID and BACK of a local batch: its SegmentOut."""
    starts, n_items, pk1, bestq, bestro, bufs, _ = front_body_b(
        bufs, seg_lens, depth)
    m_cap = _bucket(max(int(n_items.max()), 1), 1 << 14, 2)
    items = mid_body_b(starts, n_items, pk1, bestq, bestro, bufs, seg_lens,
                       m_cap)[0]
    return back_body_b(items, chunk_input, c_max)


def batched_encode(bufs: torch.Tensor, seg_lens: torch.Tensor, level: int,
                   chunk_input: int, c_max: int, mesh: Optional[Mesh] = None,
                   device: str | torch.device = "cuda") -> SegmentOut:
    """The OTZ1 chain over padded (B, N) segments, each device of the mesh
    taking its block (on `device` alone without a mesh); returns the
    SegmentOut (meta, words) on the CPU."""
    mesh = [resolve_device(d, "batched_encode")
            for d in ((device,) if mesh is None else mesh)]
    depth = candidate_depth(level)

    def local(dev, block):
        out = _otz1_local(bufs[block.start:block.stop].to(dev),
                          seg_lens[block.start:block.stop].to(dev), depth,
                          chunk_input, c_max)
        return out.meta.cpu(), out.words.cpu()

    outs = _on_mesh(mesh, local, _blocks(bufs.shape[0], mesh))
    return SegmentOut(torch.cat([o[0] for o in outs]),
                      torch.cat([o[1] for o in outs]))


def mesh_encode_segments(
    segments: List[bytes],
    level: int = 2,
    chunk_input: int = CHUNK_INPUT_DEFAULT,
    mesh: Optional[Mesh] = None,
) -> List[bytes]:
    """Encode segments block-data-parallel through the OTZ1 chain, on one
    shape bucket; returns the payloads in order (an empty segment's is its
    header)."""
    if not segments:
        return []
    if mesh is None:
        mesh = blocks_mesh()
    cap = _bucket_capacity(max(len(s) for s in segments))
    bufs, lens = pad_batch(segments, cap)
    out = batched_encode(torch.from_numpy(bufs), torch.from_numpy(lens),
                         level, chunk_input, n_chunks_for(cap, chunk_input),
                         mesh)
    metas, words = fetch_out(out)
    return [assemble(s, metas[i], words[i], chunk_input, 0) if s
            else empty_payload(chunk_input) for i, s in enumerate(segments)]


# --- the OTZ2 (default l2) chain over the mesh -------------------------------


def _sr_caps_for(cap: int) -> tuple:
    """JAX's static symrank caps for its shard_map chain: the wide phase
    runs while more than 128 contexts are active (r1 is small); the narrow
    phase must reach the hottest context's item count, roughly cap/12
    items on text, so the cap scales with the bucket (floored for small
    segments).  A segment past either cap is flagged."""
    r1_cap = max(1 << 10, min(1 << 12, cap >> 9))
    rm_cap = max(1 << 13, min(1 << 17, cap >> 4))
    return r1_cap, rm_cap


def _flags(ok, r1, rounds, r1_cap: int, rm_cap: int) -> list:
    """Per segment: None, or why it is flagged."""
    ok, r1, rounds = (t.cpu().numpy() for t in (ok, r1, rounds))
    return [None if o and a <= r1_cap and r - a <= rm_cap else
            "repair" if not o else f"r1 {a} > {r1_cap}" if a > r1_cap else
            f"rounds - r1 {r - a} > {rm_cap}"
            for o, a, r in zip(ok, r1, rounds)]


def _otz2_chain_local(datas, level: int, cap: int, chunk_input: int,
                      device) -> list:
    """The OTZ2 chain over a device's non-empty segments: per segment, its
    payload, or the reason it is flagged (a str)."""
    c_max = n_chunks_for(cap, chunk_input)
    r1_cap, rm_cap = _sr_caps_for(cap)
    bufs, seg_lens = (torch.from_numpy(a).to(device)
                      for a in pad_batch(datas, cap))
    starts, n_items, pk1, _, _, bufs, mask0 = front_body_b(
        bufs, seg_lens, candidate_depth(level))
    head, tail, c_shifts = quality_split(otz2_schedule(level))
    plan, mask, _ = quality_scan_body(bufs, seg_lens, mask0, n_items, head)
    del mask0
    it_a, it_b = quality_tail_body(bufs, seg_lens, plan, starts, n_items,
                                   pk1, mask, tail, c_shifts)
    del plan, mask, starts, n_items, pk1
    m2_cap = min(cap, m2_cap_for(int(torch.stack([it_a[1], it_b[1]]).max())))
    items, ok, r1, rounds, dem_a, dem_b = mid2_body(bufs, seg_lens, it_a,
                                                    it_b, m2_cap)
    # an emission that reached the bucket may repair at cap (JAX's m2_cap):
    # those segments are emitted again there (dem_a is dem_b when only B
    # was emitted, which at worst emits a segment again needlessly)
    redo = ((it_a[1] + dem_a > m2_cap) | (it_b[1] + dem_b > m2_cap)) \
        if m2_cap < cap else torch.zeros_like(ok)
    redo = redo.cpu().numpy()
    again = {b: tuple(tuple(t[b:b + 1] for t in it) for it in (it_a, it_b))
             for b in np.flatnonzero(redo)}
    del it_a, it_b
    flags = _flags(ok, r1, rounds, r1_cap, rm_cap)
    metas, words = fetch_out(back_body_b(without_failed(items, ok),
                                         chunk_input, c_max))
    del items
    out = [flags[b] or assemble(d, metas[b], words[b], chunk_input, 1)
           for b, d in enumerate(datas)]
    for b, (it_a1, it_b1) in again.items():
        lens1 = seg_lens[b:b + 1]
        items1, ok1, r11, rounds1 = mid2_body(bufs[b:b + 1], lens1, it_a1,
                                              it_b1, cap)[:4]
        flag = _flags(ok1, r11, rounds1, r1_cap, rm_cap)[0]
        if flag is None:
            m1, w1 = fetch_out(back_body_b(items1, chunk_input, c_max))
            out[b] = assemble(datas[b], m1[0], w1[0], chunk_input, 1)
        else:
            out[b] = flag
    return out


def mesh_encode_segments_staged(
    segments: List[bytes],
    level: int = 2,
    chunk_input: int = CHUNK_INPUT_DEFAULT,
    mesh: Optional[Mesh] = None,
    flagged: Optional[list] = None,
) -> List[bytes]:
    """Encode segments through the default l2 (OTZ2) chain, block-data-
    parallel over the mesh, each device encoding len(segments)/len(mesh)
    of them.  Flagged segments (repair failed, or symrank rounds past the
    static caps) re-encode through the staged encoder at rings_mode 1 on
    their device; `flagged`, if given, receives (index, reason) for each."""
    if not segments:
        return []
    if mesh is None:
        mesh = blocks_mesh()
    cap = _bucket_capacity(max(len(s) for s in segments))

    def local(dev, block):
        idx = [i for i in block if segments[i]]
        got = (_otz2_chain_local([segments[i] for i in idx], level, cap,
                                 chunk_input, dev) if idx else [])
        out = dict(zip(idx, got))
        for i in block:
            p = out.get(i, "empty")
            if isinstance(p, str):
                if p != "empty" and flagged is not None:
                    flagged.append((i, p))
                out[i] = encode_segment_staged(segments[i], level,
                                               chunk_input, rings_mode=1,
                                               device=dev)
        return [out[i] for i in block]

    blocks = _on_mesh(mesh, local, _blocks(len(segments), mesh))
    if flagged is not None:
        flagged.sort()
    return [p for block in blocks for p in block]
