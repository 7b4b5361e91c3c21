"""JAX's recorded outputs, the one recorder of the port's tests.

It writes two files:

- ``tests/torch_parity_digests.json``: stream parity at the shape the
  encoder runs (``CASES``).  Each case's data is
  ``orz_tpu_torch.tools.parity_data.make_parity_data``'s (numpy-free, so
  every machine draws the same bytes); JAX encodes it with
  ``orz_tpu.device.container.tpu_encode_bytes`` on XLA:CPU, batched (the
  default) and staged (``ORZ_PER_SEGMENT=1``), and for ``S-l1`` also with
  ``orz_tpu.parallel.mesh.mesh_encode_segments`` over ``blocks_mesh(4)``
  (its two segments twice over: one a device, ``parity_data.mesh_segments``).
  For each case the file records the arguments, the schedule as
  ``otz2_schedule(level)`` returns it, the data's SHA-256 and, per path,
  each segment payload's length and SHA-256, the ORZT stream's SHA-256 and
  JAX's seconds.  The port's batched chain then runs the case on the CPU
  (``encode_segments_batch(..., device="cpu")``): the file records its
  seconds, whether its payloads equal JAX's, and how many of its items have
  a reduced offset at or past ``FAR_RO_1`` and ``FAR_RO_2``.
  ``tests/test_torch_parity_shape.py``, ``tests/test_torch_cuda.py`` and
  ``chip_smoke.py``'s ``jax parity`` phase hold the port to it.
- ``tests/torch_jax_records.json``: what the port's CPU tests compare with
  JAX (``RECORDS``), one record a test or fixture, named in its ``test``
  field.  A record holds the SHA-256 of the test's inputs, the ``OTZ*`` /
  ``ORZ*`` variables JAX ran under (``env``; every other one cleared), the
  module attributes patched in the JAX package (``patches``), and JAX's
  outputs: each payload's ``[length, SHA-256]``, an ORZT file's
  ``stream_digests``, each compared array's ``[dtype, shape, SHA-256]``
  (``digest``: the array cast to the dtype the test compares it in, after
  the test's slices) and small integers as values.  The test builds the
  same inputs, checks them against the record (``expect``), runs the port
  and compares its outputs' digests: no JAX program runs.

    JAX_PLATFORMS=cpu python -m tests.torch_parity_ref [NAME ...]

runs the named cases and records (all by default, smallest first) and
merges them into their file.  Every ``OTZ*``/``ORZ*`` variable is cleared
first; a staged path sets ``ORZ_PER_SEGMENT=1`` for its own run only, and
a record sets its ``env``.  Rerun a record after a change to its test's
inputs or to what it compares, never edit a file by hand.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGESTS = os.path.join(ROOT, "tests", "torch_parity_digests.json")
RECORDS_FILE = os.path.join(ROOT, "tests", "torch_jax_records.json")
KIB, MIB = 1 << 10, 1 << 20
SEED = 1

# name: (size, level, segments, segment_size, chunk_input, batch, paths)
CASES = {
    "S-l1": ("S", 1, 2, 128 * KIB, 32 * KIB, 2, ("batched", "staged", "mesh")),
    "S-l2": ("S", 2, 2, 128 * KIB, 32 * KIB, 2, ("batched", "staged")),
    "S-l3": ("S", 3, 2, 128 * KIB, 32 * KIB, 2, ("batched", "staged")),
    "L-l1": ("L", 1, 4, 1 * MIB, 256 * KIB, 4, ("batched", "staged")),
    "L-l2": ("L", 2, 4, 1 * MIB, 256 * KIB, 4, ("batched", "staged")),
    "XL-l1": ("XL", 1, 1, 8 * MIB, 2 * MIB, 1, ("batched", "staged")),
    # batched only: JAX's staged l2 at 8 MiB would take it past 45 minutes
    "XL-l2": ("XL", 2, 1, 8 * MIB, 2 * MIB, 1, ("batched",)),
}


def clear_knobs() -> None:
    for k in [k for k in os.environ if k.startswith(("OTZ", "ORZ"))]:
        del os.environ[k]


def case_data(name: str) -> bytes:
    from orz_tpu_torch.tools.parity_data import make_parity_data

    _, _, nseg, seg, *_ = CASES[name]
    return make_parity_data(SEED, nseg * seg, seg)


def jax_stream(name: str, path: str, data: bytes) -> bytes:
    """JAX's ORZT stream of the case (the mesh path's payloads framed as
    ``tpu_encode`` frames them)."""
    from orz_tpu.device.container import tpu_encode_bytes

    _, level, _, seg, chunk, batch, _ = CASES[name]
    if path == "mesh":
        from orz_tpu.parallel import blocks_mesh
        from orz_tpu.parallel.mesh import mesh_encode_segments
        from orz_tpu_torch.tools.parity_data import (MESH_DEVICES,
                                                     frame_stream,
                                                     mesh_segments)

        return frame_stream(mesh_encode_segments(
            mesh_segments(data, seg), level, chunk,
            mesh=blocks_mesh(MESH_DEVICES)), seg)
    if path == "staged":
        os.environ["ORZ_PER_SEGMENT"] = "1"
    try:
        return tpu_encode_bytes(data, level, segment_size=seg,
                                chunk_input=chunk, batch=batch)
    finally:
        os.environ.pop("ORZ_PER_SEGMENT", None)


def port_cpu_pass(name: str, data: bytes):
    """The port's batched chain on the CPU, batch by batch as
    ``torch_encode`` runs it: (payloads, its items' far counts)."""
    from orz_tpu_torch.device.host import _bucket_capacity
    from orz_tpu_torch.tools.parity_data import batch_far_counts

    _, level, _, seg, chunk, batch, _ = CASES[name]
    segs = [data[i:i + seg] for i in range(0, len(data), seg)]
    payloads, far = [], {"ro_ge_far_ro_1": 0, "ro_ge_far_ro_2": 0}
    for i in range(0, len(segs), batch):
        group = segs[i:i + batch]
        cap = min(_bucket_capacity(seg),
                  _bucket_capacity(max(len(s) for s in group)))
        got, counts = batch_far_counts(
            group + [group[0]] * (batch - len(group)), level, chunk, cap,
            device="cpu")
        payloads += got[:len(group)]
        far = {k: far[k] + counts[k] for k in far}
    return payloads, far


def run_case(name: str) -> dict:
    from orz_tpu.device.spec import otz2_schedule
    from orz_tpu_torch.tools.parity_data import stream_digests

    size, level, nseg, seg, chunk, batch, paths = CASES[name]
    data = case_data(name)
    rec = {"size": size, "level": level, "seed": SEED, "n": len(data),
           "segment_size": seg, "chunk_input": chunk, "batch": batch,
           "schedule": otz2_schedule(level),
           "data_sha256": hashlib.sha256(data).hexdigest(), "paths": {}}
    for path in paths:
        t0 = time.perf_counter()
        stream = jax_stream(name, path, data)
        rec["paths"][path] = dict(stream_digests(stream),
                                  jax_seconds=time.perf_counter() - t0)
        print(f"{name} {path}: {len(stream)} bytes, "
              f"{rec['paths'][path]['jax_seconds']:.1f} s", flush=True)
    t0 = time.perf_counter()
    payloads, far = port_cpu_pass(name, data)
    rec["port_cpu"] = {
        "seconds": time.perf_counter() - t0,
        "batched_equal": [[len(p), hashlib.sha256(p).hexdigest()]
                          for p in payloads]
        == rec["paths"]["batched"]["segments"]}
    rec["far"] = far
    print(f"{name} port cpu: {rec['port_cpu']}, far {far}", flush=True)
    return rec


# --- the port's tests' records: digests, and the check of a test's inputs ----


def digest(a, dtype: str = "int64") -> list:
    """``[dtype, shape, SHA-256]`` of the array (numpy, or a CPU tensor)
    cast to `dtype`, little-endian in C order: equal for equal values,
    whatever dtype the array was held in."""
    import numpy as np

    a = np.asarray(a.numpy() if hasattr(a, "numpy") else a)
    a = np.ascontiguousarray(a.astype(np.dtype(dtype).newbyteorder("<")))
    return [dtype, list(a.shape), hashlib.sha256(a.tobytes()).hexdigest()]


def payload_digests(payloads) -> list:
    return [[len(p), hashlib.sha256(p).hexdigest()] for p in payloads]


def inputs_sha256(*parts) -> str:
    """One SHA-256 over bytes, ints, arrays (by ``digest``) and nested
    lists or tuples of them."""
    h = hashlib.sha256()

    def add(x):
        if isinstance(x, (bytes, bytearray)):
            h.update(b"b%d:" % len(x) + bytes(x))
        elif isinstance(x, (list, tuple)):
            h.update(b"l%d:" % len(x))
            for y in x:
                add(y)
        elif isinstance(x, int):
            h.update(b"i%d:" % x)
        else:
            h.update(b"a" + json.dumps(digest(x)).encode())

    add(parts)
    return h.hexdigest()


def knobs() -> dict:
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith(("OTZ", "ORZ"))}


_loaded: dict = {}


def expect(name: str, inputs, patches: dict | None = None) -> dict:
    """The record `name`, after checking that it describes this run: the
    same inputs' SHA-256, the same ``OTZ*``/``ORZ*`` variables and the same
    patches."""
    if not _loaded:
        with open(RECORDS_FILE) as f:
            _loaded.update(json.load(f)["records"])
    rec = _loaded[name]
    assert inputs_sha256(inputs) == rec["inputs_sha256"], \
        f"{name}: the inputs are not the recorded ones"
    assert knobs() == rec["env"], f"{name}: knobs {knobs()}, " \
        f"recorded {rec['env']}"
    assert (patches or {}) == rec["patches"], f"{name}: patches differ"
    return rec


# --- the records: each builds its test's inputs as the test does -------------

SCHEDULE = "96x1,384x2"
CAP = 1 << 15  # the slice, l2 and kernel tests' (B=2) bucket


def _makers():
    from tests.conftest import make_binary_like, make_text_like

    return make_text_like, make_binary_like


def _rng(seed):
    import numpy as np

    return np.random.default_rng(seed)


@contextlib.contextmanager
def _patched(*triples):
    """Each (module, name, value) set for the with block."""
    saved = [(m, k, getattr(m, k)) for m, k, _ in triples]
    for m, k, v in triples:
        setattr(m, k, v)
    try:
        yield
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


def _parallel_segs():
    text, binary = _makers()
    rng = _rng(0x3E5)
    return [text(rng, 4000), binary(rng, 4000), text(rng, 3000),
            binary(rng, 2500)]


def rec_mesh_staged() -> dict:
    from orz_tpu.parallel import blocks_mesh
    from orz_tpu.parallel import mesh as jm

    segs, caps = _parallel_segs(), (1024, 64)
    with _patched((jm, "_sr_caps_for", lambda cap: caps)):
        got = jm.mesh_encode_segments_staged(segs, 2, mesh=blocks_mesh(4))
    return {"inputs_sha256": inputs_sha256(segs),
            "patches": {"_sr_caps_for": list(caps)},
            "payloads": payload_digests(got)}


def _mesh_otz1_batch():
    segs = _parallel_segs()
    return [segs[0], b"", segs[0][:17], segs[1]]


def rec_mesh_otz1() -> dict:
    from orz_tpu.parallel import blocks_mesh, mesh_encode_segments

    batch = _mesh_otz1_batch()
    return {"inputs_sha256": inputs_sha256(batch),
            "payloads": payload_digests(
                mesh_encode_segments(batch, 1, mesh=blocks_mesh(4)))}


def rec_per_segment_l1() -> dict:
    from orz_tpu.device.container import tpu_encode_bytes
    from orz_tpu_torch.tools.parity_data import stream_digests

    data = _makers()[0](_rng(0x9E5), 3 * 4096 + 700)
    return {"inputs_sha256": inputs_sha256(data),
            "stream": stream_digests(tpu_encode_bytes(
                data, level=1, num_streams=2, segment_size=4096))}


def _slice_segs():
    """tests/test_torch_slice.py's and tests/test_torch_l2.py's."""
    text, binary = _makers()
    rng = _rng(0x51CE)
    return [text(rng, 30000), binary(rng, 30000)]


def _iterate(it) -> dict:
    import numpy as np

    st, ni, pk1, bestq2, bestlen2 = (np.asarray(a) for a in it)
    return {"n_items": ni.tolist(),
            "starts": [digest(st[b, :k]) for b, k in enumerate(ni)],
            "pk1": digest(pk1), "bestq2": digest(bestq2),
            "bestlen2": digest(bestlen2)}


def rec_l2_chain() -> dict:
    """tests/test_torch_l2.py's JAX chain: each stage output the test
    compares, in the port's names."""
    import jax.numpy as jnp
    import numpy as np

    from orz_tpu.device.batch import (b_back_jit, b_front_jit, b_mid2_jit,
                                      b_scan_jit, b_tail_jit)
    from orz_tpu.device.pipeline import assemble_segment_np
    from orz_tpu.golden.bitio import BitEncoder
    from orz_tpu.ops.symrank_pallas import RB_BLK
    from orz_tpu_torch.device import batch as tb
    from orz_tpu_torch.device.host import _bucket, pad_batch
    from orz_tpu_torch.ops import batched as ob
    from orz_tpu_torch.spec import (CHUNK_INPUT_DEFAULT, n_chunks_for,
                                    otz2_schedule)

    segs = _slice_segs()
    head, tail, c_shifts = tb.quality_split(otz2_schedule(2))
    assert (head, tail, c_shifts) == ((96,), (384, 384), 384)
    bufs, lens = (jnp.asarray(a) for a in pad_batch(segs, CAP))
    st, ni, pk1, bq, bro, bufs_d, mask0 = b_front_jit(bufs, lens, 32)
    plan, mask, ni_h = b_scan_jit(bufs_d, lens, mask0, ni, head)
    it_a, it_b = b_tail_jit(bufs_d, lens, plan, st, ni, pk1, mask, tail,
                            c_shifts)
    m2_cap = tb.m2_cap_for(int(max(np.max(it_a[1]), np.max(it_b[1]))))
    mid2 = b_mid2_jit(bufs_d, lens, it_a, it_b, m2_cap)
    # the FRONT parse as iterate B: its matches target non-starts and
    # demote heavily, which takes the anomalous branch
    anom = b_mid2_jit(bufs_d, lens, it_a, (st, ni, pk1, it_b[3], it_b[4]),
                      m2_cap)
    items, ok, r1, rounds = mid2[:4]
    assert np.asarray(ok).all()  # no segment takes the OTZ1 fallback
    r1_h, r_h = np.asarray(r1), np.asarray(rounds)
    out = b_back_jit(items, CHUNK_INPUT_DEFAULT,
                     n_chunks_for(CAP, CHUNK_INPUT_DEFAULT),
                     _bucket(max(int(r1_h.max()), 1), RB_BLK),
                     _bucket(max(int((r_h - r1_h).max()), 1), 4 * RB_BLK))
    metas, words = np.asarray(out.meta), np.asarray(out.words)
    payloads = []
    for b, seg in enumerate(segs):
        enc = BitEncoder()
        enc.encode_varint(len(seg))
        enc.encode_varint(CHUNK_INPUT_DEFAULT)
        payloads.append(assemble_segment_np(enc, metas[b], words[b],
                                            len(seg), CHUNK_INPUT_DEFAULT,
                                            rings_mode=1))
    j_plan = [np.asarray(a) if not isinstance(a, tuple) else a
              for a in plan]
    where = ("sp_h2", "sval_h2", "first_h2", None, "sp_ctx", "first_ctx",
             None, "msk", "msp")
    plan_rec = {name: digest(np.stack(j_plan[9], axis=1).view(np.int32)
                             if name == "dw_s" else j_plan[where.index(name)])
                for name in ob.MaskedPlan._fields}
    names = ob.Items._fields + ("ok", "r1", "rounds", "dem_a", "dem_b")
    return {
        "inputs_sha256": inputs_sha256(segs),
        "plan": plan_rec,
        # JAX's inverse permutations of sp_h2, sp_ctx and msp
        "plan_dest": [digest(j_plan[i]) for i in (3, 6, 10)],
        "mask": digest(mask), "n_items": digest(ni_h),
        "it_a": _iterate(it_a), "it_b": _iterate(it_b), "m2_cap": m2_cap,
        "mid2": [[n, digest(a)] for n, a in
                 zip(names, tuple(mid2[0]) + tuple(mid2[1:]))],
        "anom": [[n, digest(a)] for n, a in
                 zip(names, tuple(anom[0]) + tuple(anom[1:]))],
        "back_meta": digest(metas),
        "back_words": [digest(words[b, :int(metas[b, 3])])
                       for b in range(len(segs))],
        "payloads": payload_digests(payloads),
    }


def _pipeline_segs():
    text, binary = _makers()
    rng = _rng(0x7E5)
    t = text(rng, 4000)
    return {"text": t, "binary": binary(rng, 4000), "17": t[:17],
            "empty": b""}


# tests/test_torch_pipeline.py's cases: name -> (segment, level, OTZ2)
STAGED_L2 = {"text": ("text", 2, None), "binary": ("binary", 2, None),
             "17 bytes": ("17", 2, None), "empty": ("empty", 2, None),
             "OTZ2=0 text": ("text", 2, "0")}
STAGED_OTZ1 = {"l1 text": ("text", 1, None), "l0 text": ("text", 0, None),
               "l1 17 bytes": ("17", 1, None),
               "l1 empty": ("empty", 1, None)}
DEVICE = {"l1 text": ("text", 1), "l0 text": ("text", 0),
          "l1 binary": ("binary", 1)}
SKEW_CAP = 64


def _staged(segs, cases) -> dict:
    from orz_tpu.device import pipeline as jp

    out = {}
    for name, (seg, level, otz2) in cases.items():
        if otz2 is not None:
            os.environ["OTZ2"] = otz2
        try:
            payload = jp.encode_segment_staged(segs[seg], level)
        finally:
            os.environ.pop("OTZ2", None)
        out[name] = {"level": level, "otz2": otz2,
                     "payload": payload_digests([payload])[0]}
    return out


def rec_staged_l2() -> dict:
    from orz_tpu.device.batch import encode_segments_batch

    segs = _pipeline_segs()
    batch = [segs["text"], b"", segs["binary"]]
    return {"inputs_sha256": inputs_sha256([segs["text"], segs["binary"]]),
            "staged": _staged(segs, STAGED_L2),
            "batch": payload_digests(encode_segments_batch(batch, 2))}


def rec_staged_otz1() -> dict:
    from orz_tpu.device import batch as jb
    from orz_tpu.device import pipeline as jp
    from orz_tpu.ops import symrank_pallas

    segs = _pipeline_segs()
    device = {name: {"level": level, "payload": payload_digests(
        [jp.encode_segment_device(segs[seg], level)])[0]}
        for name, (seg, level) in DEVICE.items()}
    with _patched((jb, "R_CAP_MAX", SKEW_CAP),
                  (symrank_pallas, "R_CAP_MAX", SKEW_CAP)):
        skew = jb.encode_segments_batch([segs["text"], segs["binary"]], 1)
    return {"inputs_sha256": inputs_sha256([segs["text"], segs["binary"]]),
            "staged": _staged(segs, STAGED_OTZ1), "device": device,
            "skew": {"R_CAP_MAX": SKEW_CAP,
                     "payloads": payload_digests(skew)}}


def rec_slice_chain() -> dict:
    """tests/test_torch_slice.py's JAX FRONT (depth 32), MID and BACK."""
    import jax.numpy as jnp
    import numpy as np

    from orz_tpu.device.batch import b_back_jit, b_front_jit, b_mid_jit
    from orz_tpu.ops.symrank_pallas import RB_BLK
    from orz_tpu_torch.device.host import _bucket, pad_batch
    from orz_tpu_torch.spec import CHUNK_INPUT_DEFAULT, n_chunks_for

    segs = _slice_segs()
    bufs, lens = (jnp.asarray(a) for a in pad_batch(segs, CAP))
    front = b_front_jit(bufs, lens, 32)
    st, ni, pk1, bq, bro, bufs_d, mask = front
    ni_h = np.asarray(ni)
    m_cap = _bucket(int(ni_h.max()), 1 << 14, 2)
    items, r1, rounds = b_mid_jit(st, ni, pk1, bq, bro, bufs_d, lens, m_cap)
    r1_h, r_h = np.asarray(r1), np.asarray(rounds)
    out = b_back_jit(items, CHUNK_INPUT_DEFAULT,
                     n_chunks_for(CAP, CHUNK_INPUT_DEFAULT),
                     _bucket(max(int(r1_h.max()), 1), RB_BLK),
                     _bucket(max(int((r_h - r1_h).max()), 1), 4 * RB_BLK))
    meta, words = np.asarray(out.meta), np.asarray(out.words)
    st_h = np.asarray(st)
    return {
        "inputs_sha256": inputs_sha256(segs),
        "front": {"n_items": ni_h.tolist(),
                  "starts": [digest(st_h[b, :k]) for b, k in enumerate(ni_h)],
                  "pk1": digest(pk1), "bestq": digest(bq),
                  "bestro": digest(bro), "mask": digest(mask)},
        "mid": {"items": [digest(a) for a in items], "r1": digest(r1),
                "rounds": digest(rounds)},
        "back": {"meta": digest(meta), "words_shape": list(words.shape),
                 "words": [digest(words[b, :int(meta[b, 3])], "uint32")
                           for b in range(meta.shape[0])]},
    }


def rec_slice_payloads() -> dict:
    from orz_tpu.device.batch import encode_segments_batch

    segs = _slice_segs()
    return {"inputs_sha256": inputs_sha256(segs),
            "levels": {str(level): payload_digests(
                encode_segments_batch(segs, level, rings_mode=0))
                for level in (0, 1, 2)}}


def _kernel_candidates():
    """tests/test_torch_kernels.py's ``candidates``: the port's K1 inputs
    from its FRONT helpers."""
    import torch

    from orz_tpu_torch.device.host import pad_batch
    from orz_tpu_torch.ops import batched as ob
    from orz_tpu_torch.spec import PAD_FRONT

    text, binary = _makers()
    rng = _rng(0x70C4)
    bufs, lens = (torch.from_numpy(a) for a in
                  pad_batch([text(rng, 30000), binary(rng, 30000)], CAP))
    p = torch.arange(bufs.shape[1])
    valid = (p >= PAD_FRONT) & (p < (PAD_FRONT + lens).view(-1, 1))
    ba = ob.byte_arrays_b(bufs)
    rank = ob.context_ranks_b(ba, valid)
    msk, msp, rank_s, dw_s = ob.candidate_arrays_b(ba, rank, valid)
    return msk, msp, rank_s, dw_s, (PAD_FRONT + lens).int()


def rec_match_depth() -> dict:
    """``match_depth_pallas`` (interpret mode) on each row, at each depth
    the test runs."""
    import jax.numpy as jnp

    from orz_tpu.ops.match_pallas import match_depth_pallas
    from orz_tpu_torch.device.host import N_DW

    msk, msp, rank_s, dw_s, end = cand = _kernel_candidates()
    depths = {}
    for depth in (4, 8, 32):
        depths[str(depth)] = [[digest(w) for w in match_depth_pallas(
            jnp.asarray(msk[b].numpy()), jnp.asarray(msp[b].numpy()),
            jnp.asarray(rank_s[b].numpy()),
            tuple(jnp.asarray(dw_s[b, t].numpy()) for t in range(N_DW)),
            jnp.int32(int(end[b])), depth=depth)]
            for b in range(msk.shape[0])]
    return {"inputs_sha256": inputs_sha256(list(cand)), "depths": depths}


CLI_SEG, CLI_SEG2 = 1 << 15, 1 << 12


def _cli_data() -> bytes:
    text, binary = _makers()
    rng = _rng(0xC11)
    return text(rng, 2 * CLI_SEG) + binary(rng, CLI_SEG)


def _jax_cli_file(data: bytes, seg: int, *args: str) -> dict:
    """``stream_digests`` of ``python -m orz_tpu.cli encode -s -b tpu -p 2
    *args`` on data, in-process with seg-byte segments."""
    import functools
    import tempfile

    from orz_tpu.cli import main as jax_main
    from orz_tpu.device import container as jc
    from orz_tpu_torch.tools.parity_data import stream_digests

    with tempfile.TemporaryDirectory() as tmp, _patched(
            (jc, "tpu_encode", functools.partial(jc.tpu_encode,
                                                 segment_size=seg)),
            (jc, "DEFAULT_SEGMENT_SIZE", seg)):
        src, out = os.path.join(tmp, "in.bin"), os.path.join(tmp, "out.orz")
        with open(src, "wb") as f:
            f.write(data)
        argv = ["encode", "-s", "-b", "tpu", "-p", "2", *args]
        argv = [a.replace("{tmp}", tmp) for a in argv] + [src, out]
        assert jax_main(argv) == 0
        with open(out, "rb") as f:
            return stream_digests(f.read())


def _rec_cli(level: int) -> dict:
    data = _cli_data()
    return {"inputs_sha256": inputs_sha256(data),
            "patches": {"segment_size": CLI_SEG},
            "stream": _jax_cli_file(data, CLI_SEG, "-l", str(level))}


def _checkpoint_data() -> bytes:
    """tests/test_torch_cli.py's l2 --checkpoint input: three CLI_SEG2
    segments and a short one."""
    data = _cli_data()
    return data[:3 * CLI_SEG2] + data[:1000]


def rec_checkpoint_l2() -> dict:
    data2 = _checkpoint_data()
    return {"inputs_sha256": inputs_sha256(data2),
            "patches": {"segment_size": CLI_SEG2},
            "stream": _jax_cli_file(data2, CLI_SEG2, "-l", "2",
                                    "--checkpoint", "{tmp}/ck.json")}


# name: (the test or fixture that reads it, env, recorder)
RECORDS = {
    "per-segment-l1": (
        "test_torch_parallel.py::test_per_segment_env_matches_tpu_encode",
        {"ORZ_PER_SEGMENT": "1"}, rec_per_segment_l1),
    "mesh-otz1": (
        "test_torch_parallel.py::test_mesh_encode_segments_matches_jax",
        {}, rec_mesh_otz1),
    "mesh-staged": ("test_torch_parallel.py::test_mesh_staged_matches_jax",
                    {"OTZ2_SCHEDULE": SCHEDULE}, rec_mesh_staged),
    "match-depth": (
        "test_torch_kernels.py::test_match_depth_plain_matches_pallas",
        {}, rec_match_depth),
    "cli-l1": ("test_torch_cli.py::test_cli_matches_jax_cli[1-None]", {},
               lambda: _rec_cli(1)),
    "cli-l2-OTZ2=0": ("test_torch_cli.py::test_cli_matches_jax_cli[2-0]",
                      {"OTZ2": "0"}, lambda: _rec_cli(2)),
    "checkpoint-l2": ("test_torch_cli.py::jax_checkpoint_l2",
                      {"OTZ2_SCHEDULE": SCHEDULE}, rec_checkpoint_l2),
    "slice-chain": ("test_torch_slice.py::jax_chain", {}, rec_slice_chain),
    "slice-payloads": ("test_torch_slice.py::test_payloads_match_jax", {},
                       rec_slice_payloads),
    "staged-otz1": (
        "test_torch_pipeline.py::test_staged_otz1_and_device_match_jax",
        {"OTZ2_SCHEDULE": SCHEDULE}, rec_staged_otz1),
    "staged-l2": ("test_torch_pipeline.py::test_staged_l2_matches_jax",
                  {"OTZ2_SCHEDULE": SCHEDULE}, rec_staged_l2),
    "l2-chain": ("test_torch_l2.py::jax_chain", {"OTZ2_SCHEDULE": SCHEDULE},
                 rec_l2_chain),
}


def run_record(name: str) -> dict:
    test, env, fn = RECORDS[name]
    clear_knobs()
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        body = fn()
    finally:
        clear_knobs()
    rec = {"test": f"tests/{test}", "env": env, "patches": {}, **body,
           "jax_seconds": time.perf_counter() - t0}
    print(f"{name}: {rec['jax_seconds']:.1f} s", flush=True)
    return rec


def merge(path: str, key: str, order, name: str, rec: dict) -> None:
    """Write rec as `name` into `path`'s `key` map, the file locked while
    it is read and rewritten (several recorders may run at once)."""
    with open(path, "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        f.seek(0)
        text = f.read()
        doc = (json.loads(text) if text else
               {"generator": "tests/torch_parity_ref.py", key: {}})
        doc[key][name] = rec
        doc[key] = {k: doc[key][k] for k in order if k in doc[key]}
        f.seek(0)
        f.truncate()
        json.dump(doc, f, indent=1)
        f.write("\n")


def main(argv: list[str]) -> int:
    unknown = [n for n in argv if n not in CASES and n not in RECORDS]
    if unknown:
        print(f"unknown: {unknown}; known: {list(CASES) + list(RECORDS)}")
        return 2
    clear_knobs()
    sys.path.insert(0, ROOT)
    import tests.conftest  # noqa: F401  JAX on XLA:CPU, 8 devices, as in the tests

    for name in argv or list(CASES) + list(RECORDS):
        if name in CASES:
            merge(DIGESTS, "cases", CASES, name, run_case(name))
        else:
            merge(RECORDS_FILE, "records", RECORDS, name, run_record(name))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
