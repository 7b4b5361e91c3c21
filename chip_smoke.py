"""End-to-end smoke run of the torch port on one CUDA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero; there is no CPU path):

1. device: the card's name and power limit; CUDA must be available.
2. build: nvcc builds the kernels from orz_tpu_torch/csrc, one process per
   source, all started together; prints ptxas's registers, shared memory
   and spills for each kernel.
3. kernels: K1 (match depth, depth 8 and 32), K2 (masked match depth,
   depth 384 with near gating at 96: the iteration cap 4094 and the
   conform's two-tier cap 32766/4094, on the port's own plan and FRONT
   mask), K3 (fence walk), K4 (mask walk) and K5 (symrank) at the
   main-path shape, 4 x 8 MiB segments, on inputs from the port's own
   FRONT and MID.  Exact equality with the plain versions; CUDA-event
   times of kernel and plain (plain K2 and K5 are timed once by the host
   clock: K5's is a host loop); each kernel's bound, the least time the
   card could take for the same work.  K1/K2 also print their walked
   pairs (same-key candidates within reach that the kernel's walk visits;
   K2: mask-1 candidates only) beside the slots and the mask density, K1
   the histogram of its compared pairs by their first differing dword;
   K3/K4 (one kernel; K4's counts come from it) max_chain, the steps of
   the busiest FENCE block, and chain_ms, the kernel's device time
   (profiler) on that block alone, its mask equal to the whole launch's; K5
   its kernel's device time from a torch.profiler trace (the CUDA-event
   time includes the wrapper's sort), max_chain (the largest (segment,
   context) item count) and chain_ms, the kernel's device time on that
   (segment, context)'s items alone (its serial chain, which no other
   context shortens), with the latency per item it implies.  The
   segmented scans (csrc/seg_scan.cu, no TPU kernel behind them) on
   QUALITY's inputs: the plan's group starts with the FRONT mask's word
   updates (last_marked) and item starts (exclusive_count); exact
   equality with the plain versions; CUDA-event times of kernel and
   plain, the byte bound, and one int64 torch.cummax over the same slots
   (what each of the plain versions' scans costs) as a yardstick.  Then
   the running max and the exclusive sum on MID2's own inputs, caught
   from one l2 encode of the 4 x 8 MiB batch: the item merge's
   _seg_cummax (grouped) and cand_of_queries (one group a row) over
   2 * mc slots, _expand_b's offsets over mc; equality, kernel and plain
   times and the byte bound (9 bytes a slot with the group flags, 8
   without).
4. gather: P1 (the windowed gather) at the probe's default size, m = 2^21
   outputs from n = 2^23 words, on the probe's ascending indices and on
   the four edge cases (in window, fill, wrap, clamp): exact equality
   with the plain version; CUDA-event times of kernel, plain and the
   library call src[idx], the device times of kernel and src[idx] from a
   torch.profiler trace and the host time to issue each call, each call
   on the next of 4 copies of the inputs (more than L2 holds); the bound.  Then P1's own path, the probe
   (orz_tpu_torch.tools.gather_probe), which must exit 0 with ok=True and
   launch the kernel.
5. cpu parity: 64 KiB text-like and binary-like segments encoded on the GPU
   at l1, at l2 with rings_mode=0 and at the l2 default (OTZ2, the default
   schedule) must equal the port's CPU encode, which the CPU tests hold to
   the JAX chain and to the sequential oracle; the same data through
   torch_encode_bytes must round-trip through the native decoder; the
   per-segment encoders (encode_segment_staged at l2,
   encode_segment_device at l1) on the same segments must equal their CPU
   encode.
6. refcodec (phase_refcodec): the card's payloads against the port's
   sequential oracle (orz_tpu_torch/device/refcodec.py), and torch_decode's
   fallback to it, forced once.  Every other phase must leave
   decoder_fallbacks at 0 (the command line's subprocesses print their
   own count), so that the native decoder is what decoded.
6b. jax parity (phase_jax_parity): every case of
   tests/torch_parity_digests.json (JAX's digests) on the card, batched
   and with ORZ_PER_SEGMENT=1 (S-l1 also on the mesh); then the first
   2 MiB of the e2e data at l1 against encode_segment_ref, run in a
   process of its own from the start of cpu parity (35-60 s a MiB on one
   host core of the card's machine).
7. e2e l2 (the main path): 32 MiB through torch_encode_bytes(level=2) with
   the defaults (8 MiB segments, batch 4, 2 MiB chunks), twice, decoded by
   the native decoder; every kernel of the encoder must have launched, no
   segment may have gone through the per-segment retry, the second pass
   must give the same bytes.  Its stream and launches feed the phases
   below.  Level 1 is held on the card by jax parity (XL-l1: one 8 MiB
   segment, batched and staged) and inflight.
8. inflight (phase_inflight): 64 MiB at l2 and l1, at ORZ_INFLIGHT=1 and
   2: equal bytes, launches and OTZ1 fallbacks, a native round trip.
9. staged (phase_staged): the per-segment staged encoder
   (device/pipeline.py) on the first 8 MiB segment at l2, and
   encode_segment_device at l1, against the batched payloads.
10. cli (phase_cli): `python -m orz_tpu_torch.cli encode -b gpu -l 2 -p 4`
   on the same 32 MiB must write the e2e l2 stream and decode it;
   --checkpoint on the first 16 MiB.
11. parallel (phase_parallel): mesh_encode_segments_staged on the four e2e
   segments and distributed_encode_file at world 1 under NCCL
   (tcp://127.0.0.1, a free port) against the e2e payloads and stream.
12. host (phase_host), on the CPU of the card's machine: the native and
   golden host codecs through the CLI, ratio_vs_orz_l2 and benchtool's
   table, whose device row must launch every encoder kernel.

Only the kernels and gather phases time their work (each kernel against
its bound); the end-to-end speed is portbench's (portbench/,
BENCHMARK.json).  Each phase prints its seconds, and the run their sum.
The last stdout line is {"ok": true, "device": {...}}; the line before it
is the per-kernel JSON record.
"""

from __future__ import annotations

import argparse
import io
import itertools
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


def host_ms(fn, reps: int) -> float:
    """Mean host milliseconds to issue one call of fn() (one warm-up call
    first), with no synchronisation inside the timed loop: where the card
    finishes each call before the host issues the next, this is what a
    call costs."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


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


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()
    return float(out[0]) * 1e6


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi printed nothing"


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "run needs a CUDA GPU")
    log(card_line())
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} numpy {np.__version__} device "
        f"{torch.cuda.get_device_name(0)}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from orz_tpu_torch.kernels import _lib

    t = time.perf_counter()
    path = _lib.library()._name
    log(f"build: {time.perf_counter() - t:.2f} s -> "
        f"{os.path.relpath(path, ROOT)}")
    for out in _lib.build_log:  # empty when the library was already built
        for ln in out.splitlines():
            if ln.endswith(":") or "Compiling entry" in ln or "Used" in ln \
                    or "spill" in ln:
                log(f"  {ln.strip()}")


def _batch_inputs(data: bytes, seg: int, bsz: int):
    import torch

    from orz_tpu_torch.device.host import _bucket_capacity, pad_batch

    segs = [data[i * seg:(i + 1) * seg] for i in range(bsz)]
    bufs, lens = pad_batch(segs, _bucket_capacity(seg))
    return (torch.from_numpy(bufs).cuda(), torch.from_numpy(lens).cuda())


# --- bounds -------------------------------------------------------------------

# NVIDIA H100 SXM (NVIDIA's data sheet, at the full 700 W): 3.35 TB/s of
# device memory.  The kernels do 32-bit integer work, for which the table
# of published peaks gives no rate: 33.5 T operations/s is taken, half the
# 67 TFLOP/s float32 rate (which counts a fused multiply-add as two).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move over the memory rate and its operations over the
    operation rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def match_bound(msk, msp, rank_s, dw_s, end, depth: int, ro_cap: int,
                mask_s=None, near: int = 0) -> dict:
    """K1/K2, from this run's data.  Bytes: every slot's key (and mask
    byte) read and its 3 words written; a slot's rank read when it is in a
    same-key pair that passes the mask gates; a query's position read
    when it compares a pair (its LCP cap); and each slot's dwords read up
    to the first that differs, the deepest over its compared pairs, within
    the cap, for the pairs whose cap reaches their length gate (no other
    pair can match).  Operations: 3 (compare the key, subtract the ranks,
    compare the offset) per same-key pair within the window.  Also returns
    ``walked_pairs``: the same-key pairs within each query's reach whose
    candidate the kernel's walk visits (K2: mask 1), the walk's work
    before its stops at the cap; and ``dword_hist``: of the pairs that
    compare dwords (those that pass the offset cap and the gate), the
    count whose first differing dword is t, for t = 0..15, then the count
    equal through the cap (every dword that the cap reaches)."""
    import torch

    from orz_tpu_torch.device.host import N_DW
    from orz_tpu_torch.kernels.match_depth import (
        min_match_len_for_ro,
        shift_dn,
    )
    from orz_tpu_torch.spec import FENCE, PAD_FRONT

    bsz, n = msk.shape
    cap = torch.minimum(FENCE - ((msp - PAD_FRONT) & (FENCE - 1)),
                        end.view(-1, 1) - msp)
    cap_dw = ((cap + 3) // 4).clamp(0, N_DW)
    need_rank = torch.zeros_like(msk, dtype=torch.bool)
    need_pos = torch.zeros_like(msk, dtype=torch.bool)
    n_dw = torch.zeros(bsz * n, dtype=torch.int64, device=msk.device)
    pairs = walked = 0
    hist = torch.zeros(N_DW + 1, dtype=torch.int64, device=msk.device)
    for j in range(1, min(depth, n - 1) + 1):
        same = torch.zeros_like(need_rank)
        same[:, j:] = msk[:, j:] == msk[:, :-j]
        if not bool(same.any()):  # sorted keys: no pair at any larger j
            break
        gated = same
        if mask_s is not None:
            if near and j > near:
                gated = gated & mask_s
            pairs += int(gated.sum())
            gated = gated & shift_dn(mask_s, j, False)
        else:
            pairs += int(gated.sum())
        walked += int(gated.sum())
        need_rank |= gated
        need_rank[:, :-j] |= gated[:, j:]
        ro = rank_s - 1 - shift_dn(rank_s, j, 0)
        ok = gated & (ro < ro_cap) & (cap >= min_match_len_for_ro(ro))
        b, i = ok.nonzero(as_tuple=True)
        if b.numel() == 0:
            continue
        need_pos[b, i] = True
        nz = (dw_s[b, :, i] ^ dw_s[b, :, i - j]) != 0
        first = torch.where(nz.any(dim=1), nz.int().argmax(dim=1), N_DW)
        hist += torch.bincount(torch.where(first < cap_dw[b, i], first, N_DW),
                               minlength=N_DW + 1)
        t = torch.minimum(first + 1, cap_dw[b, i]).long()
        for slot in (b * n + i, b * n + i - j):
            n_dw.scatter_reduce_(0, slot, t, "amax")
    nbytes = (bsz * n * (4 + 12 + (1 if mask_s is not None else 0))
              + 4 * (int(need_rank.sum()) + int(need_pos.sum())
                     + int(n_dw.sum()) + bsz))
    return dict(bound(nbytes, 3 * pairs), walked_pairs=walked,
                dword_hist=hist.tolist())


def walk_bound(n_items_total: int, bsz: int, n: int, counts: bool) -> dict:
    """K3/K4: the walk reads nxt at each item start only and writes the
    (B, n) byte mask (K4 also the B counts); 3 operations per step."""
    return bound(4 * n_items_total + bsz * n + (4 * bsz if counts else 0)
                 + 4 * bsz, 3 * n_items_total)


def walk_chain(nxt, lens, mask) -> dict:
    """K3/K4's longest chain: max_chain, the steps (item starts) of the
    busiest block of this launch's `mask`, and chain_ms, the walk kernel's
    device time (profiler) on that block alone, placed as block 0 of a
    one-segment row; its mask must equal `mask` on that block."""
    import torch
    import torch.nn.functional as F

    from orz_tpu_torch.kernels import walk_mask
    from orz_tpu_torch.spec import FENCE, PAD_FRONT

    bsz, n = mask.shape
    n_blocks = -(-(n - PAD_FRONT) // FENCE)
    per_block = F.pad(mask[:, PAD_FRONT:].int(),
                      (0, n_blocks * FENCE - (n - PAD_FRONT))
                      ).view(bsz, n_blocks, FENCE).sum(dim=2)
    b, k = divmod(int(per_block.argmax()), n_blocks)
    base = PAD_FRONT + k * FENCE
    width = min(FENCE, n - base)
    one = torch.zeros((1, PAD_FRONT + FENCE), dtype=torch.int32,
                      device=nxt.device)
    one[0, PAD_FRONT:PAD_FRONT + width] = nxt[b, base:base + width] - (
        base - PAD_FRONT)
    one_len = (lens[b:b + 1] + PAD_FRONT - base).clamp(0, width).int()
    got, _ = walk_mask.walk_mask(one, one_len)
    require_equal("the walk on the busiest block alone",
                  got[0, PAD_FRONT:PAD_FRONT + width],
                  mask[b, base:base + width])
    chain_ms = device_ms(lambda: walk_mask.walk_mask(one, one_len), 5,
                         "smoke_trace_walk_chain.json",
                         kernel="fence_walk_kernel")
    return {"max_chain": int(per_block.max()), "b": b, "k": k,
            "chain_ms": chain_ms}


# --- phases -------------------------------------------------------------------


def phase_kernels(data: bytes) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from orz_tpu_torch.device.host import C, _bucket
    from orz_tpu_torch.kernels import (
        fence_walk,
        match_depth,
        match_depth_masked,
        seg_scan,
        symrank,
        walk_mask,
    )
    from orz_tpu_torch.ops import batched as ob
    from orz_tpu_torch.spec import (
        OTZ2_NEAR,
        OTZ2_RO_CAP,
        PAD_FRONT,
        PAD_TAIL,
        RING,
        n_chunks_for,
    )

    rec = {}
    bufs, lens = _batch_inputs(data, 8 * MIB, 4)
    bsz, n = bufs.shape
    p = torch.arange(n, device=bufs.device)
    valid = (p >= PAD_FRONT) & (p < (PAD_FRONT + lens).view(-1, 1))
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
        bd = match_bound(*args, RING)
        log(f"K1 match_depth depth {depth} B=4 n={n}: equal, kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bd['bound_ms']:.3f} ms ({bd['bound_by']}); {bsz * n} slots, "
            f"{bd['walked_pairs']} walked pairs "
            f"({bd['walked_pairs'] / (bsz * n):.2f} a slot); compared "
            f"pairs by first differing dword 0..15, then equal to the cap: "
            f"{bd['dword_hist']}")
        if depth == 32:  # FRONT's depth at l2, the main path
            rec["match_depth"] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms, **bd)
    del msk, msp, rank_s, dw_s, rank, ba

    # K2 on QUALITY's inputs: the port's plan and the l2 FRONT's mask
    mask = ob.front_body_b(bufs, lens, 32)[6]
    plan = ob.masked_plan_b(bufs, lens)
    order = plan.msp.long()
    rank_s = torch.gather(ob.masked_context_counts_planned_b(plan, valid,
                                                              mask), 1, order)
    mask_s = torch.gather(mask, 1, order)
    variants = (("iteration", OTZ2_RO_CAP, None), ("conform", RING,
                                                   OTZ2_RO_CAP))
    for variant, ro_cap, near_cap in variants:
        args = (plan.msk, plan.msp, rank_s, plan.dw_s, end, mask_s, 384,
                ro_cap, OTZ2_NEAR, near_cap)
        got = match_depth_masked.match_depth_masked(*args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = match_depth.match_depth_plain(*args[:5], 384, ro_cap, mask_s,
                                             OTZ2_NEAR, near_cap)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        err = require_equal(f"match_depth_masked {variant}", got, want)
        del want
        ms = cuda_ms(lambda: match_depth_masked.match_depth_masked(*args), 5)
        bd = match_bound(*args[:5], 384, ro_cap, mask_s, OTZ2_NEAR)
        log(f"K2 match_depth_masked {variant} depth 384 near {OTZ2_NEAR} "
            f"ro_cap {ro_cap} near cap {near_cap} B=4 n={n}: equal, "
            f"{int((got[0] >= 0).sum())} matches, kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms (once), bound {bd['bound_ms']:.3f} ms "
            f"({bd['bound_by']}); {bsz * n} slots, mask density "
            f"{float(mask_s.float().mean()):.4f}, {bd['walked_pairs']} "
            f"walked pairs ({bd['walked_pairs'] / (bsz * n):.2f} a slot)")
        if variant == "iteration":  # QUALITY's 11 deep steps
            rec["match_depth_masked"] = dict(max_abs_err=err, ms=ms,
                                             plain_ms=plain_ms, **bd)
    # the segmented scans as QUALITY's masked analysis calls them
    x = p.expand(bsz, n)
    upd = (x >= PAD_FRONT - 2) & (x < end.view(-1, 1)) & ob._rolll(mask, 3)
    scans = (("last_marked", seg_scan.last_marked, seg_scan.last_marked_plain,
              plan.first_h2, torch.gather(upd, 1, plan.sp_h2)),
             ("exclusive_count", seg_scan.exclusive_count,
              seg_scan.exclusive_count_plain, plan.first_ctx,
              torch.gather(mask & valid, 1, plan.sp_ctx)))
    del upd, x
    bd = bound(6 * bsz * n, 0)  # two bool flags read, one int32 written
    for name, fn, plain, first, marked in scans:
        err = require_equal(f"seg_scan {name}", fn(first, marked),
                            plain(first, marked))
        ms = cuda_ms(lambda: fn(first, marked), 20)
        plain_ms = cuda_ms(lambda: plain(first, marked), 3)
        ivals = torch.where(marked, p.expand(bsz, n), -1)
        cummax_ms = cuda_ms(lambda: torch.cummax(ivals, dim=1), 3)
        del ivals
        log(f"seg_scan {name} B=4 n={n}: equal, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, one int64 torch.cummax {cummax_ms:.3f} ms "
            f"(yardstick), bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, "
            f"{ms / bd['bound_ms']:.2f}x); group starts "
            f"{float(first.float().mean()):.2e} of the slots, marked "
            f"{float(marked.float().mean()):.4f}")
        if name == "last_marked":
            rec["seg_scan"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   cummax_ms=cummax_ms, **bd)
        else:
            rec["seg_scan"].update(count_ms=ms, count_plain_ms=plain_ms)
    del scans, first, marked
    del plan, order, rank_s, mask_s, mask
    rec["seg_scan"].update(scan_values(data))

    an = ob.analyze_b(bufs, lens, 32)
    nxt = ob.decisions_b(an, lens, n).nxt
    del an
    got = fence_walk.fence_walk_mask(nxt, lens)
    want = fence_walk.fence_walk_mask_plain(nxt, lens)
    err = require_equal("fence_walk", got, want)
    n_starts = int(got.sum())
    chain = walk_chain(nxt, lens, got)
    ms = cuda_ms(lambda: fence_walk.fence_walk_mask(nxt, lens), 5)
    plain_ms = cuda_ms(lambda: fence_walk.fence_walk_mask_plain(nxt, lens), 2)
    bd = walk_bound(n_starts, bsz, n, counts=False)
    log(f"K3 fence_walk B=4 n={n}: equal, {n_starts} starts, kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bd['bound_ms']:.3f} "
        f"ms; max_chain {chain['max_chain']} steps (segment {chain['b']}, "
        f"block {chain['k']}), chain_ms {chain['chain_ms']:.4f} ms (device "
        f"time of the kernel on that block alone, its mask equal to the "
        f"whole launch's there)")
    rec["fence_walk"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             max_chain=chain["max_chain"],
                             chain_ms=chain["chain_ms"], **bd)

    got = walk_mask.walk_mask(nxt, lens)
    want = walk_mask.walk_mask_plain(nxt, lens)
    err = require_equal("walk_mask", got, want)
    ms = cuda_ms(lambda: walk_mask.walk_mask(nxt, lens), 5)
    plain_ms = cuda_ms(lambda: walk_mask.walk_mask_plain(nxt, lens), 2)
    bd = walk_bound(n_starts, bsz, n, counts=True)
    log(f"K4 walk_mask B=4 n={n}: equal, n_items {got[1].tolist()} (added up "
        f"by the kernel), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bd['bound_ms']:.3f} ms; max_chain {chain['max_chain']}, chain_ms "
        f"{chain['chain_ms']:.4f} ms (as K3: one kernel)")
    rec["walk_mask"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            max_chain=chain["max_chain"],
                            chain_ms=chain["chain_ms"], **bd)
    del nxt, got, want

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
    dev_ms = device_ms(lambda: symrank.symrank(*args), 3,
                       "smoke_trace_k5.json", kernel="symrank_kernel")
    n_it = int(args[3].sum())
    m = args[0].shape[1]
    # symbol, sr_unlikely and sr_ctx of each item and the census orders
    # read once, coded written once; 10 operations per item
    bd = bound(12 * n_it + 4 * 4 * 431 + 4 * 4 * m, 10 * n_it)
    # the serial chain: the busiest (segment, context), its items alone in
    # one segment (same order, same census order), timed on the card
    live = torch.arange(m, device=args[0].device) < args[3].view(-1, 1)
    per_ctx = torch.zeros((live.shape[0], C), dtype=torch.int64,
                          device=live.device)
    per_ctx.scatter_add_(1, args[2].long().clamp(0, C - 1), live.long())
    max_chain = int(per_ctx.max())
    b, ctx = divmod(int(per_ctx.argmax()), C)
    (k,) = (live[b] & (args[2][b] == ctx)).nonzero(as_tuple=True)
    one = (args[0][b, k][None], args[1][b, k][None], args[2][b, k][None],
           torch.tensor([max_chain], dtype=torch.int32, device=k.device),
           args[4][b][None])
    require_equal("symrank on the busiest context alone",
                  symrank.symrank(*one)[0], got[b, k])
    chain_ms = device_ms(lambda: symrank.symrank(*one), 3,
                         "smoke_trace_k5_chain.json", kernel="symrank_kernel")
    item_ns = chain_ms * 1e6 / max_chain
    log(f"K5 symrank B=4 x 8 MiB ({n_it} items): equal, kernel {ms:.3f} ms "
        f"(CUDA events, with the wrapper's sort), device time of the "
        f"kernel {dev_ms:.3f} ms (profiler), plain {plain_ms:.1f} ms (host "
        f"loop), bound {bd['bound_ms']:.3f} ms; max_chain {max_chain} items "
        f"(segment {b}, context {ctx}), chain_ms {chain_ms:.3f} ms (device "
        f"time of the kernel on those items alone, equal to their codes "
        f"above): {item_ns:.2f} ns an item, "
        f"{item_ns * max_sm_clock_hz() / 1e9:.1f} cycles at the "
        f"{max_sm_clock_hz() / 1e6:.0f} MHz maximum SM clock")
    rec["symrank"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          device_ms=dev_ms, max_chain=max_chain,
                          chain_ms=chain_ms, **bd)
    return rec


def scan_values(data: bytes) -> dict:
    """The running max and the exclusive sum (csrc/seg_scan.cu ops 2 and 3)
    on the inputs MID2 gives them in one l2 encode of the first 4 x 8 MiB
    of ``data``: the first call of each (operator, grouped), caught on
    their way into the kernel, then held to the plain versions and timed.
    """
    import torch

    from orz_tpu_torch.device.batch import encode_segments_batch
    from orz_tpu_torch.kernels import seg_scan
    from orz_tpu_torch.ops import batched as ob
    from orz_tpu_torch.ops import otz2

    caught = {}

    def catch(name, fn):
        def wrapped(first, values):
            caught.setdefault((name, first is not None), (first, values))
            return fn(first, values)
        return wrapped

    saved = ob.running_max, otz2.exclusive_sum
    ob.running_max = catch("running_max", seg_scan.running_max)
    otz2.exclusive_sum = catch("exclusive_sum", seg_scan.exclusive_sum)
    try:
        encode_segments_batch([data[i * 8 * MIB:(i + 1) * 8 * MIB]
                               for i in range(4)], 2, device="cuda")
    finally:
        ob.running_max, otz2.exclusive_sum = saved
    sites = (("running_max", True, "_seg_cummax", seg_scan.running_max,
              seg_scan.running_max_plain),
             ("running_max", False, "cand_of_queries", seg_scan.running_max,
              seg_scan.running_max_plain),
             ("exclusive_sum", False, "_expand_b", seg_scan.exclusive_sum,
              seg_scan.exclusive_sum_plain))
    rec = {}
    for name, grouped, site, fn, plain in sites:
        first, values = caught[(name, grouped)]
        require_equal(f"seg_scan {name} ({site})", fn(first, values),
                      plain(first, values))
        ms = cuda_ms(lambda: fn(first, values), 20)
        plain_ms = cuda_ms(lambda: plain(first, values), 3)
        bsz, n = values.shape
        per_slot = 9 if grouped else 8  # flag, value read; int32 written
        bd = bound(per_slot * bsz * n, 0)
        log(f"seg_scan {name} ({site}) B={bsz} n={n}: equal, kernel "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}, {per_slot} B a "
            f"slot, {ms / bd['bound_ms']:.2f}x)"
            + (f"; group starts {float(first.float().mean()):.2e} of the "
               f"slots" if grouped else ""))
        rec[f"{site}_ms"] = ms
        rec[f"{site}_plain_ms"] = plain_ms
        rec[f"{site}_bound_ms"] = bd["bound_ms"]
    return rec


def phase_gather() -> dict:
    """P1 against its plain version at the probe's default size, on the
    probe's indices and the four edge cases; then the probe itself, P1's
    path, with the launch count reset just before it and read just
    after."""
    import torch

    from orz_tpu_torch.kernels import windowed_gather as wg
    from orz_tpu_torch.tools import gather_probe

    d = gather_probe.probe_data(21)
    src = torch.from_numpy(d["src"]).cuda()
    n, m = src.shape[0], d["idx"].size
    err = 0
    for case, (idx, base) in gather_probe.edge_cases(d["idx"], d["base"],
                                                     n).items():
        idx, base = torch.from_numpy(idx).cuda(), torch.from_numpy(base).cuda()
        err = max(err, require_equal(f"windowed_gather {case}",
                                     wg.windowed_gather(src, idx, base),
                                     wg.windowed_gather_plain(src, idx,
                                                              base)))
        if case == "in_window":  # the probe's indices
            if not torch.equal(wg.windowed_gather(src, idx, base), src[idx]):
                raise AssertionError("windowed_gather: differs from src[idx] "
                                     "on the probe's in-window indices")
            args = (src, idx, base)
    # one call touches about 41 MB, which nearly fits the 50 MB L2: the
    # timed calls cycle through 4 copies of the inputs (160 MiB), so that
    # each call finds its inputs in device memory, not in L2
    sets = [args] + [tuple(t.clone() for t in args) for _ in range(3)]

    def cycled(fn):
        it = itertools.cycle(sets)
        return lambda: fn(*next(it))

    def library(s, i, _b):
        return s[i]

    ms = cuda_ms(cycled(wg.windowed_gather), 20)
    plain_ms = cuda_ms(cycled(wg.windowed_gather_plain), 5)
    library_ms = cuda_ms(cycled(library), 20)
    dev_ms = device_ms(cycled(wg.windowed_gather), 20, "smoke_trace_p1.json")
    dev_library_ms = device_ms(cycled(library), 20,
                               "smoke_trace_p1_library.json")
    host = host_ms(cycled(wg.windowed_gather), 200)
    host_library = host_ms(cycled(library), 200)
    # idx read and out written once, base read once, and each distinct src
    # word read once: every probe index lies in its window (checked above);
    # 5 integer operations per output
    words = int(torch.unique(args[1]).numel())
    bd = bound(4 * (2 * m + args[2].numel() + words), 5 * m)
    # the same at the granularity of device memory, 32-byte sectors of src
    sectors = int(torch.unique(args[1] // 8).numel())
    sector_ms = bound(4 * (2 * m + args[2].numel()) + 32 * sectors,
                      5 * m)["bound_ms"]
    del sets
    log(f"P1 windowed_gather m={m} n={n}: equal in the 4 cases; 4 input "
        f"sets in turn: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, src[idx] "
        f"{library_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
        f"({bd['bound_by']}, {words} distinct src words; {sector_ms:.4f} ms "
        f"counting the {sectors} distinct 32-byte src sectors); device time "
        f"(profiler): kernel {dev_ms:.4f} ms, src[idx] {dev_library_ms:.4f} ms; "
        f"host time to issue a call: kernel {host:.4f} ms, src[idx] "
        f"{host_library:.4f} ms")

    wg.launches = 0
    rc = gather_probe.main([], device="cuda")  # P1's path: the probe
    launches = wg.launches
    if rc != 0 or launches <= 0:
        raise AssertionError(f"gather probe: exit {rc}, {launches} launches")
    log(f"gather probe: exit 0, {launches} windowed_gather launches")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "launches": launches, **bd}


# ``python -m orz_tpu_torch.cli``, then the process's decoder_fallbacks on
# stderr (0 where no ORZT stream was decoded: the module was not loaded)
CLI = """import sys
from orz_tpu_torch.cli import main
rc = main(sys.argv[1:])
c = sys.modules.get("orz_tpu_torch.device.container")
print(f"decoder_fallbacks {c.decoder_fallbacks if c else 0}", file=sys.stderr)
sys.exit(rc)
"""


def cli(*argv) -> None:
    """Runs the port's command line (``python -m orz_tpu_torch.cli *argv``,
    through ``CLI``).  Fails unless it exits 0 and the process's
    decoder_fallbacks reads 0."""
    res = subprocess.run([sys.executable, "-c", CLI, *argv],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"cli {' '.join(argv[:3])}: exit "
                             f"{res.returncode}: {res.stderr[-3000:]}")
    if res.stderr.splitlines()[-1] != "decoder_fallbacks 0":
        raise AssertionError(f"cli {' '.join(argv[:3])}: the native decoder "
                             f"did not decode: {res.stderr[-300:]}")


def phase_cli(data: bytes, stream: bytes, staged0: bytes) -> None:
    """The port's command line in subprocesses, on the e2e l2 data: its
    file must equal the e2e stream and decode through the CLI; a
    --checkpoint run on the first 16 MiB must equal the ORZT framing of the
    staged encoder's payloads of its two segments (staged0: the first's)
    and leave no sidecar."""
    import torch

    from orz_tpu_torch.device.pipeline import encode_segment_staged
    from orz_tpu_torch.tools.parity_data import frame_stream

    work = os.path.join(ROOT, "build", "smoke_cli")
    os.makedirs(work, exist_ok=True)
    path = {k: os.path.join(work, k) for k in
            ("in.bin", "out.orz", "back.bin", "in16.bin", "out16.orz",
             "ck.json")}
    half = data[:16 * MIB]
    with open(path["in.bin"], "wb") as f:
        f.write(data)
    with open(path["in16.bin"], "wb") as f:
        f.write(half)
    torch.cuda.empty_cache()  # room for the subprocesses

    def read(name) -> bytes:
        with open(path[name], "rb") as f:
            return f.read()

    cli("encode", "-b", "gpu", "-l", "2", "-p", "4", path["in.bin"],
        path["out.orz"])
    if read("out.orz") != stream:
        raise AssertionError("cli: the encode differs from the e2e l2 stream")
    cli("decode", "-b", "gpu", path["out.orz"], path["back.bin"])
    if read("back.bin") != data:
        raise AssertionError("cli: decode does not round-trip")
    cli("encode", "-b", "gpu", "-l", "2", "-p", "4", "--checkpoint",
        path["ck.json"], path["in16.bin"], path["out16.orz"])
    staged = frame_stream([staged0, encode_segment_staged(
        half[8 * MIB:], 2, device="cuda")], 8 * MIB)
    if read("out16.orz") != staged:
        raise AssertionError("cli: the --checkpoint encode differs from the "
                             "staged encoder's payloads")
    if os.path.exists(path["ck.json"]):
        raise AssertionError("cli: the --checkpoint sidecar was left behind")
    log("cli l2 -p 4: encode equal to the e2e stream, decode round trip ok; "
        "--checkpoint 16 MiB equal to the staged encoder's payloads, no "
        "sidecar left")
    for p in path.values():
        if os.path.exists(p):
            os.remove(p)


def phase_host(data: bytes) -> dict:
    """The host codecs and the benchtool on the e2e data.

    - ``cli encode -b native -l 2`` as an orz stream and with ``-p 4`` as
      ORZP (one 32 MiB segment here: the ORZP default), each decoded by
      ``-b native`` and by ``-b gpu`` (which reads host streams through
      auto) and equal to the input.  -b native exits 1 where the native
      build fails, and auto must resolve to the native backend here:
      golden must not run.
    - ratio_vs_orz_l2 as bench.py defines it: the port's l2 ORZT stream of
      the first 8 MiB over the native l2 orz stream of the same bytes.
    - golden against native at l0 on the first 64 KiB: equal bytes.
    - ``benchtool.main`` (``python -m orz_tpu_torch.benchtool``) on the
      first 4 MiB, one round, native backend: its table must hold a device
      row (the l2 encode on the card), whose MD5 round trip must pass.
      Every count is set to 0 just before it and read just after: the
      device row must have launched each encoder kernel.

    Returns the device row's launch counts."""
    import contextlib
    import io

    import torch

    from orz_tpu_torch import benchtool, cfg_from_level, default_backend
    from orz_tpu_torch.container import GoldenBackend, encode_bytes
    from orz_tpu_torch.device import container
    from orz_tpu_torch.native import NativeBackend

    backend = default_backend()
    log(f"host codecs: auto resolves to {type(backend).__name__}")
    if not isinstance(backend, NativeBackend):
        raise AssertionError("host: the native build failed, auto fell "
                             "back to golden")

    work = os.path.join(ROOT, "build", "smoke_host")
    os.makedirs(work, exist_ok=True)
    path = {k: os.path.join(work, k) for k in
            ("in.bin", "out.orz", "out.orzp", "back.bin", "in4.bin")}
    with open(path["in.bin"], "wb") as f:
        f.write(data)

    def read(name) -> bytes:
        with open(path[name], "rb") as f:
            return f.read()

    for name, par in (("out.orz", []), ("out.orzp", ["-p", "4"])):
        cli("encode", "-b", "native", "-l", "2", *par, path["in.bin"],
            path[name])
        head = read(name)[:5]
        if (head == b"ORZP\x01") != bool(par):
            raise AssertionError(f"host: {name} has the magic {head!r}")
        for backend_name in ("native", "gpu"):
            cli("decode", "-b", backend_name, path[name], path["back.bin"])
            if read("back.bin") != data:
                raise AssertionError(f"host: decode -b {backend_name} of "
                                     f"{name} does not round-trip")
        kind = "ORZP -p 4" if par else "orz"
        log(f"host cli encode -b native -l 2, {kind}: {len(read(name))} "
            f"bytes, ratio {len(read(name)) / len(data):.6f}; decode -b "
            f"native and -b gpu round trips ok")

    sample = data[:8 * MIB]
    orz_size = len(encode_bytes(sample, cfg_from_level(2), backend))
    otz_size = len(container.torch_encode_bytes(sample, level=2,
                                                device="cuda"))
    log(f"ratio_vs_orz_l2 {otz_size / orz_size:.6f}: the port's l2 ORZT "
        f"stream of the first 8 MiB {otz_size} bytes over the native l2 orz "
        f"stream {orz_size} bytes")

    head = data[:64 << 10]
    golden = encode_bytes(head, cfg_from_level(0), GoldenBackend())
    if golden != encode_bytes(head, cfg_from_level(0), backend):
        raise AssertionError("host: golden and native differ at l0 on 64 KiB")
    log(f"golden = native at l0 on the first 64 KiB: {len(golden)} bytes "
        f"equal")

    with open(path["in4.bin"], "wb") as f:
        f.write(data[:4 * MIB])
    mods = _kernel_modules()
    torch.cuda.synchronize()
    for mod in mods.values():
        mod.launches = 0
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = benchtool.main([path["in4.bin"], "--rounds", "1", "--backend",
                             "native"])
    launches = {k: mod.launches for k, mod in mods.items()}
    if rc != 0 or "FAILED" in err.getvalue():
        raise AssertionError(f"benchtool: exit {rc}: {err.getvalue()[-3000:]}")
    if "**orz-tpu -b gpu -l2**" not in out.getvalue():
        raise AssertionError("benchtool: no device row")
    log(f"benchtool on the first 4 MiB, --rounds 1 --backend native: "
        f"{len(out.getvalue().splitlines())} lines of table, device row MD5 "
        f"round trip ok, launches {launches}")
    for k in ENCODER_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"benchtool: kernel {k} never launched")
    for p in path.values():
        if os.path.exists(p):
            os.remove(p)
    return launches


def phase_cpu_parity(seed: int) -> None:
    from orz_tpu_torch.device import container
    from orz_tpu_torch.device.batch import encode_segments_batch
    from orz_tpu_torch.device.pipeline import (
        encode_segment_device,
        encode_segment_staged,
    )

    rng = np.random.default_rng(seed)
    segs = [text_span(rng, _vocab(rng)), binary_span(rng)]
    for level, rings_mode in ((1, 0), (2, 0), (2, None)):
        name = f"l{level} rings_mode={'default' if rings_mode is None else 0}"
        t = time.perf_counter()
        got = encode_segments_batch(segs, level, rings_mode=rings_mode,
                                    device="cuda")
        want = encode_segments_batch(segs, level, rings_mode=rings_mode,
                                     device="cpu")
        for kind, payload, ref in zip(("text", "binary"), got, want):
            if payload != ref:
                raise AssertionError(f"cpu parity: {name} {kind} payload "
                                     f"differs from the CPU encode")
        data = b"".join(segs)
        comp = container.torch_encode_bytes(data, level=level,
                                            rings_mode=rings_mode,
                                            segment_size=1 << 16,
                                            device="cuda")
        if container.torch_decode_bytes(comp) != data:
            raise AssertionError(f"cpu parity: {name} stream does not "
                                 f"round-trip through the native decoder")
        log(f"cpu parity {name}: 2 x 64 KiB byte-identical to the CPU "
            f"encode, native round trip ok ({time.perf_counter() - t:.1f} s)")
    for name, fn, level in (("encode_segment_staged l2", encode_segment_staged,
                             2),
                            ("encode_segment_device l1", encode_segment_device,
                             1)):
        t = time.perf_counter()
        for kind, seg in zip(("text", "binary"), segs):
            if fn(seg, level, device="cuda") != fn(seg, level, device="cpu"):
                raise AssertionError(f"cpu parity: {name} {kind} payload "
                                     f"differs from the CPU encode")
        log(f"cpu parity {name}: 2 x 64 KiB byte-identical to the CPU "
            f"encode ({time.perf_counter() - t:.1f} s)")


def phase_refcodec(seed: int) -> None:
    """The port's sequential oracle on the cpu parity segments (the same
    seed draws the same 64 KiB text and binary spans): GPU l1 payloads
    equal encode_segment_ref and decode through decode_segment_ref; GPU
    l2 default payloads of 16 KiB decode through decode_segment_ref and
    the native decoder; torch_decode falls back to decode_segment_ref
    when the native decoder's loader raises OSError (forced here), and
    decoder_fallbacks counts each segment."""
    from orz_tpu_torch.device import container
    from orz_tpu_torch.device.batch import encode_segments_batch
    from orz_tpu_torch.device.refcodec import (
        decode_segment_ref,
        encode_segment_ref,
    )

    rng = np.random.default_rng(seed)
    segs = [text_span(rng, _vocab(rng)), binary_span(rng)]
    kinds = ("text", "binary")
    t = time.perf_counter()
    got = encode_segments_batch(segs, 1, rings_mode=0, device="cuda")
    for kind, seg, payload in zip(kinds, segs, got):
        r = time.perf_counter()
        if payload != encode_segment_ref(seg, 1, rings_mode=0):
            raise AssertionError(f"refcodec: GPU l1 {kind} payload differs "
                                 f"from encode_segment_ref")
        e = time.perf_counter()
        if decode_segment_ref(payload) != seg:
            raise AssertionError(f"refcodec: decode_segment_ref of the GPU "
                                 f"l1 {kind} payload does not round-trip")
        log(f"refcodec l1 {kind}: {len(seg)} -> {len(payload)} bytes, GPU "
            f"payload = encode_segment_ref ({e - r:.2f} s on the host), "
            f"decode_segment_ref round trip ok "
            f"({time.perf_counter() - e:.2f} s)")
    heads = [seg[:16 << 10] for seg in segs]
    for kind, seg, payload in zip(kinds, heads, encode_segments_batch(
            heads, 2, device="cuda")):
        r = time.perf_counter()
        if decode_segment_ref(payload) != seg:
            raise AssertionError(f"refcodec: decode_segment_ref of the GPU "
                                 f"l2 {kind} payload does not round-trip")
        e = time.perf_counter()
        if container.decode_segment(payload) != seg:
            raise AssertionError(f"refcodec: the native decoder does not "
                                 f"round-trip the GPU l2 {kind} payload")
        log(f"refcodec l2 {kind}: {len(seg)} -> {len(payload)} bytes, "
            f"decode_segment_ref round trip ok ({e - r:.2f} s), native "
            f"round trip ok")
    small = segs[0][:20000] + segs[1][:12000]
    stream = container.torch_encode_bytes(small, level=1,
                                          segment_size=1 << 13,
                                          device="cuda")
    n_segs = -(-len(small) // (1 << 13))
    real = container.decoder_library

    def unloadable():
        raise OSError("the native decoder's loader, forced to fail")

    container.decoder_fallbacks = 0
    container.decoder_library = unloadable
    try:
        back = container.torch_decode_bytes(stream)
    finally:
        container.decoder_library = real
    fallbacks, container.decoder_fallbacks = container.decoder_fallbacks, 0
    if back != small or fallbacks != n_segs:
        raise AssertionError(f"refcodec: forced fallback decoded "
                             f"{len(back)} of {len(small)} bytes "
                             f"(equal: {back == small}), decoder_fallbacks "
                             f"{fallbacks} for {n_segs} segments")
    log(f"refcodec forced fallback: {len(small)} bytes in {n_segs} segments "
        f"({len(stream)} bytes of ORZT) round-trip through torch_decode "
        f"with the loader raising OSError, decoder_fallbacks {fallbacks}; "
        f"phase {time.perf_counter() - t:.2f} s")


PARITY_DIGESTS = os.path.join(ROOT, "tests", "torch_parity_digests.json")
ORACLE_BYTES = 2 * MIB  # the oracle takes 35-60 s a MiB on a host core
ORACLE_CHUNK = 512 << 10  # four chunks, the production segment's count


def oracle_segment(data: bytes) -> bytes:
    """The `jax parity` phase's oracle segment: the head of the first 8 MiB
    segment of the e2e data."""
    return data[:ORACLE_BYTES]


def timed_oracle(seg: bytes) -> tuple[bytes, float]:
    """encode_segment_ref of seg at l1 (rings_mode 0) and its seconds."""
    from orz_tpu_torch.device.refcodec import encode_segment_ref

    t = time.perf_counter()
    out = encode_segment_ref(seg, 1, chunk_input=ORACLE_CHUNK, rings_mode=0)
    return out, time.perf_counter() - t


def start_oracle(data: bytes):
    """timed_oracle of the oracle segment in a process of its own (the
    oracle is sequential numpy on one host core), so that it runs while
    the card works: (its pool, its future)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(timed_oracle, oracle_segment(data))


def phase_jax_parity(data: bytes, oracle) -> None:
    """The port on the card against JAX's digests
    (tests/torch_parity_digests.json, written by tests/torch_parity_ref.py
    from orz_tpu's tpu_encode_bytes on XLA:CPU): each case's data from
    make_parity_data, through torch_encode_bytes at the case's batch and
    with ORZ_PER_SEGMENT=1 (and S-l1 through mesh_encode_segments over
    four devices, here all the one card), every OTZ*/ORZ* knob cleared:
    every payload's SHA-256 must equal JAX's and every stream must
    round-trip through the native decoder.  Then the production shape with
    no JAX: the oracle segment on the card at l1 must equal
    encode_segment_ref (started in its own process by start_oracle)."""
    import torch

    from orz_tpu_torch.device import container
    from orz_tpu_torch.device.batch import encode_segments_batch
    from orz_tpu_torch.parallel.mesh import mesh_encode_segments
    from orz_tpu_torch.tools import parity_data as pd

    with open(PARITY_DIGESTS) as f:
        cases = json.load(f)["cases"]
    knobs = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith(("OTZ", "ORZ"))}
    mods = _kernel_modules()
    cuda4 = (torch.device("cuda"),) * pd.MESH_DEVICES
    try:
        for name, rec in cases.items():
            data_c = pd.make_parity_data(rec["seed"], rec["n"],
                                         rec["segment_size"])
            level, seg = rec["level"], rec["segment_size"]
            kw = dict(segment_size=seg, chunk_input=rec["chunk_input"],
                      batch=rec["batch"], device="cuda")

            def encode(path):
                if path == "mesh":
                    return pd.frame_stream(mesh_encode_segments(
                        pd.mesh_segments(data_c, seg), level,
                        rec["chunk_input"], mesh=cuda4), seg)
                return container.torch_encode_bytes(data_c, level, **kw)

            for path in rec["paths"]:
                if path == "staged":
                    os.environ["ORZ_PER_SEGMENT"] = "1"
                try:
                    stream, launches, secs = counted(
                        mods, lambda: encode(path),
                        L1_KERNELS if level == 1 else ENCODER_KERNELS,
                        f"jax parity {name} {path}")
                finally:
                    os.environ.pop("ORZ_PER_SEGMENT", None)
                faults = pd.parity_faults(rec, path, data_c, stream)
                if faults:
                    raise AssertionError(f"jax parity {name} {path}: "
                                         + "; ".join(faults))
                if container.torch_decode_bytes(stream) != (
                        b"".join(pd.mesh_segments(data_c, seg))
                        if path == "mesh" else data_c):
                    raise AssertionError(f"jax parity {name} {path}: the "
                                         f"native decoder does not "
                                         f"round-trip")
                want = rec["paths"][path]
                log(f"jax parity {name} {path}: {len(want['segments'])} x "
                    f"{seg} bytes at l{level}, chunk_input "
                    f"{rec['chunk_input']}, batch {rec['batch']}: "
                    f"{len(data_c)} -> {len(stream)} bytes, every payload "
                    f"= JAX's digest (JAX on XLA:CPU "
                    f"{want['jax_seconds']:.1f} s), native round trip ok; "
                    f"{secs:.2f} s on the card, launches {launches}")
    finally:
        os.environ.update(knobs)

    pool, fut = oracle
    head = oracle_segment(data)
    t = time.perf_counter()
    got = encode_segments_batch([head], 1, ORACLE_CHUNK, rings_mode=0,
                                device="cuda")[0]
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    with pool:
        want, oracle_s = fut.result()
    waited = time.perf_counter() - t
    if got != want:
        raise AssertionError(f"jax parity: the card's l1 payload of the "
                             f"first {len(head)} bytes of the e2e data "
                             f"differs from encode_segment_ref")
    log(f"jax parity oracle: the first {len(head)} bytes of the e2e data at "
        f"l1, chunk_input {ORACLE_CHUNK} ({len(head) // ORACLE_CHUNK} "
        f"chunks): card payload ({card_s:.2f} s) = encode_segment_ref "
        f"({len(want)} bytes, {oracle_s:.1f} s on one host core in its own "
        f"process; waited {waited:.1f} s for it)")


def _kernel_modules() -> dict:
    from orz_tpu_torch.kernels import (
        fence_walk,
        match_depth,
        match_depth_masked,
        seg_scan,
        symrank,
        walk_mask,
        windowed_gather,
    )

    return {"match_depth": match_depth,
            "match_depth_masked": match_depth_masked,
            "fence_walk": fence_walk, "walk_mask": walk_mask,
            "symrank": symrank, "windowed_gather": windowed_gather,
            "seg_scan": seg_scan}


def e2e(data: bytes) -> tuple[dict, bytes]:
    """Two passes of torch_encode_bytes at l2 with the defaults (counts
    reset just before the first and read just after it) and a native
    decode; returns the counts and the stream."""
    from orz_tpu_torch.device import batch, container

    container.segment_retries = 0
    batch.otz1_fallbacks = 0
    comp, launches, _ = counted(
        _kernel_modules(),
        lambda: container.torch_encode_bytes(data, level=2, device="cuda"),
        ENCODER_KERNELS, "e2e l2")
    retries = container.segment_retries
    log(f"e2e l2 encode: {len(data)} -> {len(comp)} bytes, launches "
        f"{launches}, segment_retries {retries}, OTZ1-fallback segments "
        f"{batch.otz1_fallbacks}")
    if retries:
        raise AssertionError(f"e2e l2: {retries} segments went through the "
                             f"per-segment retry")
    if container.torch_encode_bytes(data, level=2, device="cuda") != comp:
        raise AssertionError("e2e l2: second pass produced different bytes")
    if container.torch_decode_bytes(comp) != data:
        raise AssertionError("e2e l2: native decode does not round-trip")
    log("e2e l2: second pass byte-identical, native round trip ok")
    return launches, comp


def device_events(prof, name: str) -> list[dict]:
    """The device events (kernels, copies, sets) of a finished
    torch.profiler run, from its trace, which is kept as build/<name>."""
    path = os.path.join(ROOT, "build", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def device_ms(fn, reps: int, name: str, kernel: str | None = None) -> float:
    """Mean device time per call of fn(): the summed durations of the
    device events (those whose name contains `kernel`, if given) in a
    torch.profiler trace of `reps` calls (after one warm-up call).  Unlike
    CUDA events around the calls, it leaves out the gaps in which the card
    waits for the host to launch the next one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without them
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in device_events(prof, name)
                  if kernel is None or kernel in e["name"]]
        if events:
            return sum(e["dur"] for e in events) / 1e3 / reps
        log(f"{name}: the trace holds no device events"
            + (f" named {kernel}" if kernel else "") + "; tracing again")
    raise AssertionError(f"{name}: three traces without the device events")


def counted(mods: dict, fn, path_kernels, what: str):
    """fn() with every kernel count set to 0 just before it and read just
    after: (its result, the counts, host seconds).  Fails if a kernel of
    `path_kernels` was launched no time."""
    import torch

    torch.cuda.synchronize()
    for mod in mods.values():
        mod.launches = 0
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = {k: mod.launches for k, mod in mods.items()}
    for k in path_kernels:
        if launches[k] <= 0:
            raise AssertionError(f"{what}: kernel {k} never launched")
    return out, launches, secs


def phase_staged(data: bytes, l2_payloads: list[bytes]) -> bytes:
    """The per-segment staged encoder on the first 8 MiB segment at l2 (the
    default schedule): native round trip, the best-of-N emissions, equality
    with the batched e2e payload where only the newest iterate was emitted,
    launches, the same bytes from a second run; and encode_segment_device at
    l1, which must equal the batched rings_mode=0 payload.  Returns the
    staged payload."""
    from orz_tpu_torch.device import pipeline as tp
    from orz_tpu_torch.device.batch import encode_segments_batch
    from orz_tpu_torch.device.container import decode_segment
    from orz_tpu_torch.spec import CHUNK_INPUT_DEFAULT as CI

    seg = data[:8 * MIB]
    mods = _kernel_modules()

    def staged():
        mid = tp.dispatch_segment_mid2(tp.dispatch_segment_front(
            seg, 2, CI, "cuda"))
        return mid["emissions"], mid["thr"], tp.finish_segment(
            seg, tp.dispatch_segment_back(mid), CI)

    (emissions, thr, payload), launches, _ = counted(
        mods, staged, ENCODER_KERNELS, "staged l2")
    if decode_segment(payload) != seg:
        raise AssertionError("staged l2: native decode does not round-trip")
    same = payload == l2_payloads[0]
    if len(emissions) == 1 and not same:
        raise AssertionError("staged l2: only the newest iterate was emitted "
                             "but the payload differs from the batched one")
    if staged()[2] != payload:
        raise AssertionError("staged l2: a second run differs")
    log(f"staged l2 on the first 8 MiB segment: {len(payload)} bytes, ratio "
        f"{len(payload) / len(seg):.6f}; emissions (ok, demoted) newest "
        f"first {emissions}, thr {thr}; equal to the batched e2e payload: "
        f"{same}; native round trip ok; launches {launches}; a second run "
        f"gives the same bytes")

    want = encode_segments_batch([seg], 1, device="cuda")[0]
    got, launches, _ = counted(
        mods, lambda: tp.encode_segment_device(seg, 1, device="cuda"),
        ["match_depth", "fence_walk", "symrank"], "device l1")
    if got != want:
        raise AssertionError("encode_segment_device l1 differs from the "
                             "batched rings_mode=0 payload")
    log(f"encode_segment_device l1 on the first 8 MiB segment: equal to the "
        f"batched rings_mode=0 payload, launches {launches}")
    return payload


def phase_parallel(data: bytes, stream: bytes) -> None:
    """The multi-GPU layer on the e2e data: mesh_encode_segments_staged on
    the four segments equals the batched e2e payloads except for the
    flagged segments, each of which equals encode_segment_staged at
    rings_mode 1; distributed_encode_file at world 1 under NCCL writes the
    e2e l2 stream.  Counts reset just before each and read just after."""
    import socket

    import torch
    import torch.distributed as dist

    from orz_tpu_torch.device.pipeline import encode_segment_staged
    from orz_tpu_torch.parallel import (
        blocks_mesh,
        distributed,
        mesh_encode_segments_staged,
    )
    from orz_tpu_torch.tools.parity_data import stream_payloads

    mesh = blocks_mesh()
    log(f"parallel: len(blocks_mesh()) = {len(mesh)} ({card_line()})")
    segs = [data[i * 8 * MIB:(i + 1) * 8 * MIB] for i in range(4)]
    want = stream_payloads(stream)
    mods = _kernel_modules()
    flagged = []
    got, launches, _ = counted(
        mods, lambda: mesh_encode_segments_staged(segs, 2, mesh=mesh,
                                                  flagged=flagged),
        ENCODER_KERNELS, "mesh")
    idx = {i for i, _ in flagged}
    for i, (seg, p, w) in enumerate(zip(segs, got, want)):
        if i in idx:
            if p != encode_segment_staged(seg, 2, rings_mode=1,
                                          device="cuda"):
                raise AssertionError(f"mesh: flagged segment {i} differs "
                                     f"from encode_segment_staged")
        elif p != w:
            raise AssertionError(f"mesh: segment {i} differs from the "
                                 f"batched e2e payload")
    log(f"mesh_encode_segments_staged, 4 x 8 MiB over {len(mesh)} device(s): "
        f"launches {launches}; flagged "
        f"{len(flagged)} {flagged}, each equal to encode_segment_staged; "
        f"the others equal to the batched e2e payloads")

    work = os.path.join(ROOT, "build", "smoke_parallel")
    os.makedirs(work, exist_ok=True)
    src, out = os.path.join(work, "in.bin"), os.path.join(work, "out.orz")
    with open(src, "wb") as f:
        f.write(data)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.maybe_initialize("cuda", f"tcp://127.0.0.1:{port}", 1, 0)
    try:
        backend = dist.get_backend()
        _, launches, _ = counted(
            mods, lambda: distributed.distributed_encode_file(src, out, 2),
            ENCODER_KERNELS, "distributed")
    finally:
        dist.destroy_process_group()
    with open(out, "rb") as f:
        if f.read() != stream:
            raise AssertionError("distributed_encode_file differs from the "
                                 "e2e l2 stream")
    log(f"distributed_encode_file at world 1 under {backend}: launches "
        f"{launches}, the e2e l2 stream byte for byte")
    for p in (src, out):
        os.remove(p)
    torch.cuda.empty_cache()


def phase_inflight(seed: int) -> None:
    """Batches in flight: 64 MiB, two 4 x 8 MiB batches at the defaults,
    through torch_encode_bytes at l2 and l1, once at ORZ_INFLIGHT=1, then
    twice at 2 (the first takes the second slot's allocations, the second
    reuses them), each with the counts set to 0 just before it and read
    just after.  The bytes, the launches and otz1_fallbacks must be equal
    at 1 and 2, every encoder kernel of the level must launch, no segment
    may take the per-segment retry, and the stream must round-trip through
    the native decoder."""
    import torch

    from orz_tpu_torch.device import batch, container

    t = time.perf_counter()
    data = make_data(seed, 64 * MIB)
    log(f"inflight data: {len(data)} bytes from seed {seed} "
        f"({time.perf_counter() - t:.1f} s)")
    mods = _kernel_modules()
    before = os.environ.get("ORZ_INFLIGHT")
    try:
        for level, path in ((2, ENCODER_KERNELS), (1, L1_KERNELS)):
            runs = []  # (bytes, launches, OTZ1 fallbacks)
            for inflight, n in (("1", 1), ("2", 1), ("2", 2)):
                os.environ["ORZ_INFLIGHT"] = inflight
                what = f"inflight l{level} ORZ_INFLIGHT={inflight}"
                container.segment_retries = 0
                batch.otz1_fallbacks = 0
                comp, launches, _ = counted(
                    mods, lambda: container.torch_encode_bytes(
                        data, level=level, device="cuda"), path, what)
                log(f"{what} pass {n}: {len(data)} -> {len(comp)} bytes, "
                    f"launches {launches}, segment_retries "
                    f"{container.segment_retries}, OTZ1-fallback segments "
                    f"{batch.otz1_fallbacks}")
                if container.segment_retries:
                    raise AssertionError(f"{what}: segments went through "
                                         f"the per-segment retry")
                runs.append((comp, launches, batch.otz1_fallbacks))
                if comp != runs[0][0]:
                    raise AssertionError(f"{what}: the bytes differ from "
                                         f"those at ORZ_INFLIGHT=1")
                if runs[-1][1:] != runs[0][1:]:
                    raise AssertionError(
                        f"{what}: launches and OTZ1 fallbacks "
                        f"{runs[-1][1:]}, at ORZ_INFLIGHT=1 {runs[0][1:]}")
            if container.torch_decode_bytes(runs[0][0]) != data:
                raise AssertionError(f"inflight l{level}: native decode does "
                                     f"not round-trip")
            log(f"inflight l{level}: bytes, launches and OTZ1 fallbacks equal "
                f"at ORZ_INFLIGHT=1 and 2, native round trip ok")
    finally:
        if before is None:
            os.environ.pop("ORZ_INFLIGHT", None)
        else:
            os.environ["ORZ_INFLIGHT"] = before
    torch.cuda.empty_cache()


KERNEL_INFO = {
    "match_depth": ("orz_tpu_torch/csrc/match_depth.cu",
                    "orz_tpu/ops/match_pallas.py:258"),
    "match_depth_masked": ("orz_tpu_torch/csrc/match_depth.cu",
                           "orz_tpu/ops/match_pallas.py:63"),
    "fence_walk": ("orz_tpu_torch/csrc/fence_walk.cu",
                   "orz_tpu/ops/walk_pallas.py:116"),
    "walk_mask": ("orz_tpu_torch/csrc/fence_walk.cu",
                  "orz_tpu/ops/walk_pallas.py:171"),
    "symrank": ("orz_tpu_torch/csrc/symrank.cu",
                "orz_tpu/ops/symrank_pallas.py:204"),
    "windowed_gather": ("orz_tpu_torch/csrc/windowed_gather.cu",
                        "tools/gather_probe.py:74"),
    "seg_scan": ("orz_tpu_torch/csrc/seg_scan.cu",
                 "none: ATen int64 scans in place of lax.associative_scan"),
}
ENCODER_KERNELS = ["match_depth", "match_depth_masked", "fence_walk",
                   "walk_mask", "symrank", "seg_scan"]  # the l2 main path's
L1_KERNELS = ["match_depth", "fence_walk", "symrank", "seg_scan"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    device = phase_device()
    import torch

    torch.cuda.set_device(0)
    seconds = {}

    from orz_tpu_torch.device import container
    from orz_tpu_torch.tools.parity_data import stream_payloads

    def phase(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t
        log(f"phase {name}: {seconds[name]:.1f} s")
        if container.decoder_fallbacks:  # refcodec resets its own
            raise AssertionError(f"{name}: decoder_fallbacks "
                                 f"{container.decoder_fallbacks}: the "
                                 f"native decoder did not decode")
        return out

    phase("build", phase_build)
    t = time.perf_counter()
    data = make_data(args.seed, 32 * MIB)
    log(f"data: {len(data)} bytes from seed {args.seed} "
        f"({time.perf_counter() - t:.1f} s)")
    rec = phase("kernels", phase_kernels, data)
    rec["windowed_gather"] = phase("gather", phase_gather)  # with the probe
    oracle = start_oracle(data)  # runs on a host core from here on
    phase("cpu parity", phase_cpu_parity, args.seed)
    phase("refcodec", phase_refcodec, args.seed)
    phase("jax parity", phase_jax_parity, data, oracle)
    launches, stream = phase("e2e l2", e2e, data)  # the main path
    for k in ENCODER_KERNELS:
        rec[k].update(launches=launches[k], library_ms=None)
    phase("inflight", phase_inflight, args.seed)
    staged0 = phase("staged", phase_staged, data,
                    stream_payloads(stream))
    phase("cli", phase_cli, data, stream, staged0)
    phase("parallel", phase_parallel, data, stream)
    del stream
    phase("host", phase_host, data)
    log("decoder_fallbacks 0 after every phase but refcodec's forced one, "
        "in this process and in each command line process")
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in seconds.items())
        + f"; total {sum(seconds.values()):.1f}")
    kernels = [
        {"name": k, "route": "cuda", "source": KERNEL_INFO[k][0],
         "replaces": KERNEL_INFO[k][1], **rec[k]}
        for k in KERNEL_INFO
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
