"""End-to-end smoke run of the torch port on one CUDA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero; there is no CPU path):

1. device: the card's name and power limit; CUDA must be available.
2. build: nvcc builds the three kernels from orz_tpu_torch/csrc.
3. kernels: K1 (match depth, depth 8 and 32), K3 (fence walk) and K5
   (symrank) at the main-path shape, 4 x 8 MiB segments, on inputs from
   the port's own FRONT and MID.  Exact equality with the plain versions;
   CUDA-event times of kernel and plain (plain K5 is a host loop, timed by
   the host clock).
4. cpu parity: 64 KiB text-like and binary-like segments encoded on the GPU
   at l1 and l2 (rings_mode=0) must equal the port's CPU encode, which the
   CPU tests hold to the JAX chain and to the sequential oracle; the same
   data through torch_encode_bytes must round-trip through the native
   decoder.
5. e2e: 32 MiB through torch_encode_bytes(level=1) with the defaults
   (8 MiB segments, batch 4, 2 MiB chunks), decoded by the shared native
   decoder; every kernel must have launched and no segment may have gone
   through the per-segment retry.  Then per-stage times of one 4 x 8 MiB
   batch.
6. profile: one warm 4 x 8 MiB encode_segments_batch under torch.profiler;
   prints its wall time, device busy time (union of kernel, copy and set
   intervals), idle share and the kernels that take the most device time.

The last stdout line is {"ok": true, "device": {...}}; the line before it
is the per-kernel JSON record.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

MIB = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


# --- data ---------------------------------------------------------------------


_SEPS = [b" ", b" ", b" ", b"\n", b", ", b". "]


def _vocab(rng) -> list[bytes]:
    letters = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
    vocab = [bytes(rng.choice(letters, size=int(rng.integers(2, 11))))
             for _ in range(3000)]
    return vocab + [b"the", b"of", b"and", b"0123456789", b"(x)", b"[i]"]


def text_span(rng, vocab: list[bytes], n: int = 1 << 16) -> bytes:
    """Zipf-distributed words and separators."""
    out = b""
    while len(out) < n:
        idx = (rng.zipf(1.25, size=n // 4) - 1) % len(vocab)
        sep = rng.integers(len(_SEPS), size=idx.size)
        out += b"".join(vocab[i] + _SEPS[s] for i, s in zip(idx, sep))
    return out[:n]


def binary_span(rng, n: int = 1 << 16) -> bytes:
    """Runs, random bytes and repeated blocks."""
    out = bytearray()
    while len(out) < n:
        c = rng.random()
        if c < 0.3:
            out += bytes([int(rng.integers(256))]) * int(rng.integers(1, 64))
        elif c < 0.6:
            out += rng.integers(0, 256, size=int(rng.integers(1, 128)),
                                dtype=np.uint8).tobytes()
        else:
            take = min(len(out), int(rng.integers(4, 256)))
            out += out[len(out) - take:]
    return bytes(out[:n])


def make_data(seed: int, n: int) -> bytes:
    """n bytes of 64 KiB spans: 60% text-like, 40% binary-like, 5% of them
    long-range repeats of an earlier span."""
    rng = np.random.default_rng(seed)
    vocab = _vocab(rng)
    spans = []
    while len(spans) << 16 < n:
        if spans and rng.random() < 0.05:
            spans.append(spans[int(rng.integers(len(spans)))])
        elif rng.random() < 0.6:
            spans.append(text_span(rng, vocab))
        else:
            spans.append(binary_span(rng))
    return b"".join(spans)[:n]


# --- timing -------------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() on the current stream (one
    warm-up call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(a, b) -> int:
    import torch

    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def require_equal(name: str, a, b) -> int:
    err = max_abs_err(a, b)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from plain version "
                             f"(max abs err {err})")
    return err


# --- phases -------------------------------------------------------------------


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "run needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(smi[0] if smi else "nvidia-smi printed nothing")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from orz_tpu_torch.kernels import _lib

    t = time.perf_counter()
    path = _lib.library()._name
    log(f"build: {time.perf_counter() - t:.2f} s -> "
        f"{os.path.relpath(path, ROOT)}")


def _batch_inputs(data: bytes, seg: int, bsz: int):
    import torch

    from orz_tpu_torch.device.host import _bucket_capacity, pad_batch

    segs = [data[i * seg:(i + 1) * seg] for i in range(bsz)]
    bufs, lens = pad_batch(segs, _bucket_capacity(seg))
    return (torch.from_numpy(bufs).cuda(), torch.from_numpy(lens).cuda())


def phase_kernels(data: bytes) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from orz_tpu_torch.device.host import (
        PAD_FRONT,
        PAD_TAIL,
        _bucket,
        n_chunks_for,
    )
    from orz_tpu_torch.kernels import fence_walk, match_depth, symrank
    from orz_tpu_torch.ops import batched as ob

    rec = {}
    bufs, lens = _batch_inputs(data, 8 * MIB, 4)
    n = bufs.shape[1]
    valid = ((torch.arange(n, device=bufs.device) >= PAD_FRONT)
             & (torch.arange(n, device=bufs.device) < (PAD_FRONT + lens)
                .view(-1, 1)))
    ba = ob.byte_arrays_b(bufs)
    rank = ob.context_ranks_b(ba, valid)
    msk, msp, rank_s, dw_s = ob.candidate_arrays_b(ba, rank, valid)
    end = (PAD_FRONT + lens).int()
    for depth in (8, 32):
        args = (msk, msp, rank_s, dw_s, end, depth)
        got = match_depth.match_depth(*args)
        want = match_depth.match_depth_plain(*args)
        err = require_equal(f"match_depth d{depth}", got, want)
        ms = cuda_ms(lambda: match_depth.match_depth(*args), 5)
        plain_ms = cuda_ms(lambda: match_depth.match_depth_plain(*args), 2)
        log(f"K1 match_depth depth {depth} B=4 n={n}: equal, kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
        if depth == 8:  # the level-1 depth the e2e phase runs
            rec["match_depth"] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms)
    del msk, msp, rank_s, dw_s

    an = ob.analyze_b(bufs, lens, 8)
    nxt = ob.decisions_b(an, lens, n).nxt
    got = fence_walk.fence_walk_mask(nxt, lens)
    want = fence_walk.fence_walk_mask_plain(nxt, lens)
    err = require_equal("fence_walk", got, want)
    ms = cuda_ms(lambda: fence_walk.fence_walk_mask(nxt, lens), 5)
    plain_ms = cuda_ms(lambda: fence_walk.fence_walk_mask_plain(nxt, lens), 2)
    log(f"K3 fence_walk B=4 n={n}: equal, {int(got.sum())} starts, kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    rec["fence_walk"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    del an, nxt

    def k5_inputs(seg):
        b, sl = _batch_inputs(data, seg, 4)
        st, ni, pk1, bq, bro, b, _ = ob.front_body_b(b, sl, 8)
        items, _, _ = ob.mid_body_b(st, ni, pk1, bq, bro, b, sl,
                                    _bucket(int(ni.max()), 1 << 14, 2))
        c_max = n_chunks_for(b.shape[1] - PAD_FRONT - PAD_TAIL, 1 << 21)
        _, _, order, _ = ob.census_b(items, 1 << 21, c_max)
        return (items.symbol, items.sr_unlikely, items.sr_ctx,
                items.n_items, order)

    args = k5_inputs(8 * MIB)
    got = symrank.symrank(*args)
    t = time.perf_counter()
    want = symrank.symrank_plain(*args)
    plain_ms = (time.perf_counter() - t) * 1e3
    err = require_equal("symrank", got, want)
    ms = cuda_ms(lambda: symrank.symrank(*args), 3)
    log(f"K5 symrank B=4 x 8 MiB ({int(args[3].sum())} items): equal, "
        f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms (host loop)")
    rec["symrank"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return rec


def phase_cpu_parity(seed: int) -> None:
    from orz_tpu_torch.device import container
    from orz_tpu_torch.device.batch import encode_segments_batch

    rng = np.random.default_rng(seed)
    segs = [text_span(rng, _vocab(rng)), binary_span(rng)]
    for level in (1, 2):
        t = time.perf_counter()
        got = encode_segments_batch(segs, level, rings_mode=0, device="cuda")
        want = encode_segments_batch(segs, level, rings_mode=0, device="cpu")
        for kind, payload, ref in zip(("text", "binary"), got, want):
            if payload != ref:
                raise AssertionError(f"cpu parity: l{level} {kind} payload "
                                     f"differs from the CPU encode")
        data = b"".join(segs)
        comp = container.torch_encode_bytes(data, level=level, rings_mode=0,
                                            segment_size=1 << 16,
                                            device="cuda")
        if container.tpu_decode_bytes(comp) != data:
            raise AssertionError(f"cpu parity: l{level} stream does not "
                                 f"round-trip through the native decoder")
        log(f"cpu parity l{level} rings_mode=0: 2 x 64 KiB byte-identical to "
            f"the CPU encode, native round trip ok "
            f"({time.perf_counter() - t:.1f} s)")


def phase_e2e(data: bytes) -> dict:
    import torch

    from orz_tpu_torch.device import container
    from orz_tpu_torch.device.batch import encode_segments_batch
    from orz_tpu_torch.device.host import _bucket
    from orz_tpu_torch.kernels import fence_walk, match_depth, symrank
    from orz_tpu_torch.ops import batched as ob

    kernels = {"match_depth": match_depth, "fence_walk": fence_walk,
               "symrank": symrank}
    encode_segments_batch([data[:4096]], 1, device="cuda")  # warm-up
    torch.cuda.synchronize()
    for mod in kernels.values():
        mod.launches = 0
    container.segment_retries = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    comp = container.torch_encode_bytes(data, level=1, device="cuda")
    cold_s = time.perf_counter() - t
    launches = {k: mod.launches for k, mod in kernels.items()}
    retries = container.segment_retries
    peak = torch.cuda.max_memory_allocated()
    log(f"e2e encode (first pass): {len(data)} -> {len(comp)} bytes, "
        f"{cold_s:.2f} s, launches {launches}, retries {retries}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"e2e: kernel {k} never launched")
    if retries:
        raise AssertionError(f"e2e: {retries} segments went through the "
                             f"per-segment retry")

    t = time.perf_counter()
    comp2 = container.torch_encode_bytes(data, level=1, device="cuda")
    warm_s = time.perf_counter() - t
    if comp2 != comp:
        raise AssertionError("e2e: second pass produced different bytes")
    t = time.perf_counter()
    back = container.tpu_decode_bytes(comp)
    dec_s = time.perf_counter() - t
    if back != data:
        raise AssertionError("e2e: native decode does not round-trip")
    log(f"e2e round trip ok: ratio {len(comp) / len(data):.6f}, encode "
        f"(warm pass) {len(data) / 1e6 / warm_s:.3f} MB/s "
        f"({warm_s:.3f} s), native decode {dec_s:.3f} s, peak device "
        f"memory {peak / 2**30:.3f} GiB")

    # per-stage device time of one 4 x 8 MiB batch, synchronised stages
    bufs, lens = _batch_inputs(data, 8 * MIB, 4)
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    st, ni, pk1, bq, bro, b2, _ = timed(
        "FRONT", lambda: ob.front_body_b(bufs, lens, 8))
    m_cap = _bucket(int(ni.max()), 1 << 14, 2)
    items, _, _ = timed("MID", lambda: ob.mid_body_b(st, ni, pk1, bq, bro,
                                                     b2, lens, m_cap))
    timed("BACK", lambda: ob.back_body_b(items, 1 << 21, 4))
    log("e2e stage times, one 4 x 8 MiB batch (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()))
    return launches


def phase_profile(data: bytes) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from orz_tpu_torch.device.batch import encode_segments_batch

    segs = [data[i * 8 * MIB:(i + 1) * 8 * MIB] for i in range(4)]
    encode_segments_batch(segs, 1, device="cuda")  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        encode_segments_batch(segs, 1, device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    path = os.path.join(ROOT, "build", "smoke_profile.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        raise AssertionError("profile: the trace holds no device events")
    busy_us, end = 0.0, float("-inf")
    for e in sorted(dev, key=lambda e: e["ts"]):  # union of intervals
        lo, hi = max(e["ts"], end), e["ts"] + e["dur"]
        if hi > lo:
            busy_us += hi - lo
        end = max(end, hi)
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    total_ms = sum(by_name.values())
    log(f"profile, one warm 4 x 8 MiB batch: wall {wall_ms:.1f} ms, device "
        f"busy {busy_us / 1e3:.1f} ms (sum of device events "
        f"{total_ms:.1f} ms), idle share {1 - busy_us / 1e3 / wall_ms:.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {ms:9.3f} ms {ms / total_ms:6.1%}  {name[:90]}")


KERNEL_INFO = {
    "match_depth": ("orz_tpu_torch/csrc/match_depth.cu",
                    "orz_tpu/ops/match_pallas.py:258"),
    "fence_walk": ("orz_tpu_torch/csrc/fence_walk.cu",
                   "orz_tpu/ops/walk_pallas.py:116"),
    "symrank": ("orz_tpu_torch/csrc/symrank.cu",
                "orz_tpu/ops/symrank_pallas.py:204"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    device = phase_device()
    import torch

    torch.cuda.set_device(0)
    phase_build()
    t = time.perf_counter()
    data = make_data(args.seed, 32 * MIB)
    log(f"data: {len(data)} bytes from seed {args.seed} "
        f"({time.perf_counter() - t:.1f} s)")
    rec = phase_kernels(data)
    phase_cpu_parity(args.seed)
    launches = phase_e2e(data)
    phase_profile(data)
    kernels = [
        {"name": k, "route": "cuda", "source": KERNEL_INFO[k][0],
         "replaces": KERNEL_INFO[k][1], "launches": launches[k], **rec[k]}
        for k in KERNEL_INFO
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
