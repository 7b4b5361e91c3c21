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
   context shortens), with the latency per item it implies.
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
   torch_encode_bytes must round-trip through the native decoder.
6. e2e l2 (the main path): 32 MiB through torch_encode_bytes(level=2) with
   the defaults (8 MiB segments, batch 4, 2 MiB chunks), decoded by the
   native decoder; every kernel of the encoder must have launched, no
   segment may have gone through the per-segment retry.
7. cli: `python -m orz_tpu_torch.cli encode -b gpu -l 2 -p 4` on the
   same 32 MiB must write the e2e l2 stream, which `... cli decode` must
   round-trip; a --checkpoint encode of the first 16 MiB must equal
   torch_encode_bytes of those bytes and remove its sidecar; MB/s of each
   process and of its own statistics (stderr).  Then
   per-stage times of one 4 x 8 MiB l2 batch (FRONT, QUALITY scan,
   QUALITY tail, MID2, BACK), read through encode_segments_batch's stage
   hook.
   Then the host codecs (phase_host), on the CPU of the card's machine:
   `cli encode -b native -l 2` as an orz stream and with `-p 4` as ORZP,
   each decoded by `-b native` and `-b gpu` to the input, MB/s over each
   process and by its statistics, the native backend required (no golden
   fallback); ratio_vs_orz_l2 (the port's l2 ORZT stream of the first
   8 MiB over the native l2 orz stream); golden = native at l0 on 64 KiB;
   benchtool's table on the first 4 MiB (one round, native), whose device
   row must round-trip and launch every encoder kernel (counts reset just
   before it, read just after).
8. e2e l1: the same 32 MiB at level 1 (K1, K3 and K5 must launch).
9. profile: one warm 4 x 8 MiB encode_segments_batch at l2 and at l1 under
   torch.profiler; prints the wall time, device busy time (union of
   kernel, copy and set intervals), idle share and the kernels that take
   the most device time.

The last stdout line is {"ok": true, "device": {...}}; the line before it
is the per-kernel JSON record.
"""

from __future__ import annotations

import argparse
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
    del plan, order, rank_s, mask_s, mask

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


def cli(*argv) -> tuple[float, str]:
    """Runs ``python -m orz_tpu_torch.cli *argv``; returns its wall seconds
    and the speed line of the statistics that it prints to stderr (timed
    from its start-up's end)."""
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "orz_tpu_torch.cli", *argv],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t
    if res.returncode != 0:
        raise AssertionError(f"cli {' '.join(argv[:3])}: exit "
                             f"{res.returncode}: {res.stderr[-3000:]}")
    speed = [ln.split(":", 1)[1].strip() for ln in res.stderr.splitlines()
             if ln.strip().startswith("speed:")]
    return wall, speed[-1] if speed else "no statistics"


def phase_cli(data: bytes, stream: bytes) -> None:
    """The port's command line in subprocesses, on the e2e l2 data: its
    file must equal the e2e stream and decode through the CLI; a
    --checkpoint run on the first 16 MiB must equal torch_encode_bytes of
    those bytes and leave no sidecar.  MB/s by the host clock around each
    subprocess (process start, torch import and CUDA set-up included), and
    the speed of the CLI's own statistics (from the end of its start-up);
    the runs are not silent (-s) so that it prints them, to stderr."""
    import torch

    from orz_tpu_torch.device import container

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

    enc_s, enc_stat = cli("encode", "-b", "gpu", "-l", "2", "-p", "4",
                          path["in.bin"], path["out.orz"])
    if read("out.orz") != stream:
        raise AssertionError("cli: the encode differs from the e2e l2 stream")
    dec_s, dec_stat = cli("decode", "-b", "gpu", path["out.orz"],
                          path["back.bin"])
    if read("back.bin") != data:
        raise AssertionError("cli: decode does not round-trip")
    ck_s, ck_stat = cli("encode", "-b", "gpu", "-l", "2", "-p", "4",
                        "--checkpoint", path["ck.json"], path["in16.bin"],
                        path["out16.orz"])
    if read("out16.orz") != container.torch_encode_bytes(half, level=2,
                                                         device="cuda"):
        raise AssertionError("cli: the --checkpoint encode differs from "
                             "torch_encode_bytes")
    if os.path.exists(path["ck.json"]):
        raise AssertionError("cli: the --checkpoint sidecar was left behind")
    log(f"cli l2 -p 4, MB/s of the whole process (its own statistics): "
        f"encode {len(data) / 1e6 / enc_s:.3f} ({enc_stat}; {enc_s:.2f} s), "
        f"equal to the e2e stream; decode {len(data) / 1e6 / dec_s:.3f} "
        f"({dec_stat}; {dec_s:.2f} s), round trip ok; --checkpoint 16 MiB "
        f"{len(half) / 1e6 / ck_s:.3f} ({ck_stat}; {ck_s:.2f} s), equal to "
        f"torch_encode_bytes, no sidecar left")
    for p in path.values():
        if os.path.exists(p):
            os.remove(p)


def phase_host(data: bytes) -> dict:
    """The host codecs and the benchtool on the e2e data.  Their numbers
    are the CPU's of the machine that holds the card, labelled so.

    - ``cli encode -b native -l 2`` as an orz stream and with ``-p 4`` as
      ORZP (one 32 MiB segment here: the ORZP default), each decoded by
      ``-b native`` and by ``-b gpu`` (which reads host streams through
      auto) and equal to the input; MB/s over each process and by its own
      statistics.  -b native exits 1 where the native build fails, and
      auto must resolve to the native backend here: golden must not run.
    - ratio_vs_orz_l2 as bench.py defines it: the port's l2 ORZT stream of
      the first 8 MiB over the native l2 orz stream of the same bytes.
    - golden against native at l0 on the first 64 KiB: equal bytes.
    - ``benchtool.main`` (``python -m orz_tpu_torch.benchtool``) on the
      first 4 MiB, one round, native backend: its table, and its device
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

    label = (f"host CPU ({os.cpu_count()} cores) of the machine that holds "
             f"{card_line()}")
    backend = default_backend()
    log(f"host codecs on the {label}: auto resolves to "
        f"{type(backend).__name__}")
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

    mb = len(data) / 1e6
    for name, par in (("out.orz", []), ("out.orzp", ["-p", "4"])):
        enc_s, enc_stat = cli("encode", "-b", "native", "-l", "2", *par,
                              path["in.bin"], path[name])
        head = read(name)[:5]
        if (head == b"ORZP\x01") != bool(par):
            raise AssertionError(f"host: {name} has the magic {head!r}")
        dec = []
        for backend_name in ("native", "gpu"):
            dec_s, dec_stat = cli("decode", "-b", backend_name, path[name],
                                  path["back.bin"])
            if read("back.bin") != data:
                raise AssertionError(f"host: decode -b {backend_name} of "
                                     f"{name} does not round-trip")
            dec.append(f"decode -b {backend_name} {mb / dec_s:.3f} "
                       f"({dec_stat}; {dec_s:.2f} s)")
        kind = "ORZP -p 4" if par else "orz"
        log(f"host cli encode -b native -l 2, {kind}, MB/s of the whole "
            f"process (its own statistics): encode {mb / enc_s:.3f} "
            f"({enc_stat}; {enc_s:.2f} s), {len(read(name))} bytes, ratio "
            f"{len(read(name)) / len(data):.6f}; {'; '.join(dec)}; "
            f"round trips ok; backend NativeBackend ({label})")

    sample = data[:8 * MIB]
    t = time.perf_counter()
    orz_size = len(encode_bytes(sample, cfg_from_level(2), backend))
    orz_s = time.perf_counter() - t
    otz_size = len(container.torch_encode_bytes(sample, level=2,
                                                device="cuda"))
    log(f"ratio_vs_orz_l2 {otz_size / orz_size:.6f}: the port's l2 ORZT "
        f"stream of the first 8 MiB {otz_size} bytes over the native l2 orz "
        f"stream {orz_size} bytes (native encode {orz_s:.3f} s in-process)")

    head = data[:64 << 10]
    t = time.perf_counter()
    golden = encode_bytes(head, cfg_from_level(0), GoldenBackend())
    golden_s = time.perf_counter() - t
    if golden != encode_bytes(head, cfg_from_level(0), backend):
        raise AssertionError("host: golden and native differ at l0 on 64 KiB")
    log(f"golden = native at l0 on the first 64 KiB: {len(golden)} bytes "
        f"equal (golden {golden_s:.2f} s)")

    with open(path["in4.bin"], "wb") as f:
        f.write(data[:4 * MIB])
    mods = _kernel_modules()
    torch.cuda.synchronize()
    for mod in mods.values():
        mod.launches = 0
    out, err = io.StringIO(), io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = benchtool.main([path["in4.bin"], "--rounds", "1", "--backend",
                             "native"])
    bench_s = time.perf_counter() - t
    launches = {k: mod.launches for k, mod in mods.items()}
    if rc != 0 or "FAILED" in err.getvalue():
        raise AssertionError(f"benchtool: exit {rc}: {err.getvalue()[-3000:]}")
    log(f"benchtool on the first 4 MiB, --rounds 1 --backend native "
        f"({bench_s:.1f} s; {label}):")
    for ln in out.getvalue().splitlines():
        log(f"  {ln}")
    if "**orz-tpu -b gpu -l2**" not in out.getvalue():
        raise AssertionError("benchtool: no device row")
    log(f"benchtool device row: MD5 round trip ok, launches {launches}")
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


def _kernel_modules() -> dict:
    from orz_tpu_torch.kernels import (
        fence_walk,
        match_depth,
        match_depth_masked,
        symrank,
        walk_mask,
        windowed_gather,
    )

    return {"match_depth": match_depth,
            "match_depth_masked": match_depth_masked,
            "fence_walk": fence_walk, "walk_mask": walk_mask,
            "symrank": symrank, "windowed_gather": windowed_gather}


def e2e(data: bytes, level: int, path_kernels) -> tuple[dict, bytes]:
    """Two passes of torch_encode_bytes at `level` (counts reset just
    before the first and read just after it) and a native decode; returns
    the counts and the stream."""
    import torch

    from orz_tpu_torch.device import batch, container
    from orz_tpu_torch.device.batch import encode_segments_batch

    mods = _kernel_modules()
    encode_segments_batch([data[:4096]], level, device="cuda")  # warm-up
    torch.cuda.synchronize()
    for mod in mods.values():
        mod.launches = 0
    container.segment_retries = 0
    batch.otz1_fallbacks = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    comp = container.torch_encode_bytes(data, level=level, device="cuda")
    cold_s = time.perf_counter() - t
    launches = {k: mod.launches for k, mod in mods.items()}
    retries = container.segment_retries
    fallbacks = batch.otz1_fallbacks
    peak = torch.cuda.max_memory_allocated()
    log(f"e2e l{level} encode (first pass): {len(data)} -> {len(comp)} bytes, "
        f"{cold_s:.2f} s, launches {launches}, segment_retries {retries}, "
        f"OTZ1-fallback segments {fallbacks}")
    for k in path_kernels:
        if launches[k] <= 0:
            raise AssertionError(f"e2e l{level}: kernel {k} never launched")
    if retries:
        raise AssertionError(f"e2e l{level}: {retries} segments went through "
                             f"the per-segment retry")

    t = time.perf_counter()
    comp2 = container.torch_encode_bytes(data, level=level, device="cuda")
    warm_s = time.perf_counter() - t
    if comp2 != comp:
        raise AssertionError(f"e2e l{level}: second pass produced different "
                             f"bytes")
    t = time.perf_counter()
    back = container.torch_decode_bytes(comp)
    dec_s = time.perf_counter() - t
    if back != data:
        raise AssertionError(f"e2e l{level}: native decode does not "
                             f"round-trip")
    log(f"e2e l{level} round trip ok: ratio {len(comp) / len(data):.6f}, "
        f"encode (warm pass) {len(data) / 1e6 / warm_s:.3f} MB/s "
        f"({warm_s:.3f} s), native decode {dec_s:.3f} s, peak device "
        f"memory {peak / 2**30:.3f} GiB")
    return launches, comp


def phase_stages(data: bytes) -> None:
    """Per-stage times of one 4 x 8 MiB l2 batch, read through
    encode_segments_batch's stage hook, each stage synchronised."""
    import torch

    from orz_tpu_torch.device.batch import encode_segments_batch

    segs = [data[i * 8 * MIB:(i + 1) * 8 * MIB] for i in range(4)]
    stages: dict[str, float] = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    t = time.perf_counter()
    encode_segments_batch(segs, 2, device="cuda", stage=timed)
    wall = (time.perf_counter() - t) * 1e3
    total = sum(stages.values())
    log("e2e l2 stage times, one 4 x 8 MiB batch (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
        + f"; sum {total:.1f} ms of {wall:.1f} ms wall, "
        f"{4 * 8 * MIB / 1e3 / wall:.3f} MB/s")


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


def phase_profile(data: bytes, level: int) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from orz_tpu_torch.device.batch import encode_segments_batch

    segs = [data[i * 8 * MIB:(i + 1) * 8 * MIB] for i in range(4)]
    encode_segments_batch(segs, level, device="cuda")  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        encode_segments_batch(segs, level, device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    dev = device_events(prof, f"smoke_profile_l{level}.json")
    if not dev:
        raise AssertionError(f"profile l{level}: the trace holds no device "
                             f"events")
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
    log(f"profile l{level}, one warm 4 x 8 MiB batch: wall {wall_ms:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms (sum of device events "
        f"{total_ms:.1f} ms), idle share {1 - busy_us / 1e3 / wall_ms:.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  {ms:9.3f} ms {ms / total_ms:6.1%}  {name[:90]}")


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
}
ENCODER_KERNELS = ["match_depth", "match_depth_masked", "fence_walk",
                   "walk_mask", "symrank"]  # the l2 main path's


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
    rec["windowed_gather"] = phase_gather()  # with P1's path, the probe
    phase_cpu_parity(args.seed)
    launches, stream = e2e(data, 2, ENCODER_KERNELS)  # the main path
    for k in ENCODER_KERNELS:
        rec[k].update(launches=launches[k], library_ms=None)
    phase_cli(data, stream)
    del stream
    phase_host(data)
    phase_stages(data)
    e2e(data, 1, ["match_depth", "fence_walk", "symrank"])
    phase_profile(data, 2)
    phase_profile(data, 1)
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
