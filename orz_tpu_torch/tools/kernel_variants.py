"""Time variants of the K1 and K3/K4 kernels on one CUDA GPU.

    python -m orz_tpu_torch.tools.kernel_variants [--seed N]

Run from the repository root (it takes ``chip_smoke.py``'s data: 32 MiB
from the seed, as 4 x 8 MiB segments, the main path's shape).  Each
variant is its own nvcc build into ``build/variants/``, all started
together, and is timed by CUDA events (mean of 5 warm launches), all in
this one process, on one card:

- K1 before its redesign, the per-slot loop reading device memory,
  cut down in three stages to find what holds it: ``keys`` (each thread
  walks its same-key candidates within the depth reading key and rank,
  no dwords and so no stop at the cap), ``+query dwords`` (also loads its
  16 dwords up front), ``full`` (also compares the candidates' dwords and
  stops at the cap: the kernel as it was), and ``grouped`` (the full
  loop reading the candidate's key, rank and first 4 dwords together,
  then 4 dwords a round trip);
- K1 as ``csrc/match_depth.cu`` builds it (``k1_t256``);
- the walk before its redesign (one thread a block, walking device
  memory, into a zeroed mask; the counts a row sum) and as
  ``csrc/fence_walk.cu`` builds it (``walk_speculative``), each without
  and with the counts (K3, K4), on FRONT's ``nxt`` at depth 32;
- each of ``PATCHES``, a source as built with one line changed:
  ``k1_t512`` tiles of 512 slots, ``k1_stage`` only stages its windows
  (no query walks), ``k1_any_occupancy`` leaves the registers to the
  compiler instead of asking for 8 CTAs an SM, ``walk_serial`` has one
  lane walk the whole staged block.

Every variant that computes the real function must equal the plain
version.  Prints one line per variant, the static SASS of K1 and of the
walk before and after their redesign (``cuobjdump -sass``, where the
toolkit has it: instructions, loads and stores by memory space, branches,
barriers and shuffles), and a JSON line of all the times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from orz_tpu_torch.device.host import N_DW
from orz_tpu_torch.kernels import _lib
from orz_tpu_torch.kernels.fence_walk import fence_walk_mask_plain
from orz_tpu_torch.kernels.match_depth import match_depth_plain
from orz_tpu_torch.spec import (
    FAR_RO_1,
    FAR_RO_2,
    FENCE,
    LZ_MATCH_MIN_LEN,
    PAD_FRONT,
    RING,
    _FAR_GATE,
)

# a kernel source as built, with one change: (variant, source, text, new)
PATCHES = (
    ("k1_t512", "match_depth.cu", "constexpr int kK1Tile = 256;",
     "constexpr int kK1Tile = 512;"),
    # stages its windows, walks nothing
    ("k1_stage", "match_depth.cu",
     "const int jmax = maxlcp >= need_min ? min(depth, i) : 0;",
     "const int jmax = 0;"),
    # registers left to the compiler instead of 8 CTAs an SM
    ("k1_any_occupancy", "match_depth.cu",
     "__launch_bounds__(kThreads, 8) match_depth_kernel",
     "__launch_bounds__(kThreads) match_depth_kernel"),
    # lane 0 walks the whole staged block
    ("walk_serial", "fence_walk.cu", "  chunked_walk(s, lane, blk_end);",
     "  if (lane == 0) walk<false>(s.jump, s.spec, nullptr, 0, blk_end);"),
)

# K1 as it was before its redesign (one thread a slot, reading device
# memory), with STAGE 0 / 1 / 2 = keys / +query dwords / full, and 3: full
# with the candidate's key, rank and dwords read 4 dwords a round trip.
_K1_BEFORE = r"""
#include <cuda_runtime.h>
namespace {
constexpr int kNDw = 16;
__global__ void k1(const int* __restrict__ msk, const int* __restrict__ msp,
                   const int* __restrict__ rank_s, const int* __restrict__ dw_s,
                   const int* __restrict__ end, int* __restrict__ best_q,
                   int* __restrict__ best_ro, int* __restrict__ best_len, int n,
                   int depth, int ro_cap, int fence, int pad_front, int min_len,
                   int gate, int far1, int far2) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t row = static_cast<size_t>(b) * n;
  const int* key_r = msk + row;
  const int* pos_r = msp + row;
  const int* rank_r = rank_s + row;
  const int* dw_r = dw_s + static_cast<size_t>(b) * kNDw * n;
  const int key = key_r[i];
  const int p = pos_r[i];
  const int rank = rank_r[i];
  const int cap = min(fence - ((p - pad_front) & (fence - 1)), end[b] - p);
  unsigned dw[kNDw];
  unsigned fold = 0u;
#pragma unroll
  for (int t = 0; t < kNDw; ++t) {
    dw[t] = STAGE >= 1 ? static_cast<unsigned>(dw_r[t * n + i]) : 0u;
    fold ^= dw[t];
  }
  int bs = 0, bq = -1, bro = 0, blen = 0;
  const int jmax = min(depth, i);
  for (int j = 1; j <= jmax; ++j) {
    const int c = i - j;
#if STAGE == 3
    const int ckey = key_r[c], crank = rank_r[c];
    unsigned x[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      x[t] = dw[t] ^ static_cast<unsigned>(dw_r[t * n + c]);
    if (ckey != key) break;
    const int ro = rank - 1 - crank;
    if (ro >= ro_cap) continue;
    int lcp = -1;
#pragma unroll
    for (int g = 0; g < kNDw; g += 4) {
      if (g > 0) {
        if (lcp >= 0) break;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          x[t] = dw[g + t] ^ static_cast<unsigned>(dw_r[(g + t) * n + c]);
      }
#pragma unroll
      for (int t = 3; t >= 0; --t)
        if (x[t] != 0u)
          lcp = 4 * (g + t) + ((__ffs(static_cast<int>(x[t])) - 1) >> 3);
    }
    if (lcp < 0) lcp = 4 * kNDw;
#else
    if (key_r[c] != key) break;
    const int ro = rank - 1 - rank_r[c];
    if (ro >= ro_cap) continue;
    if (STAGE < 2) {
      fold += static_cast<unsigned>(ro);
      continue;
    }
    int lcp = 4 * kNDw;
#pragma unroll
    for (int t = 0; t < kNDw; ++t) {
      const unsigned x = dw[t] ^ static_cast<unsigned>(dw_r[t * n + c]);
      if (x != 0u) {
        lcp = 4 * t + ((__ffs(static_cast<int>(x)) - 1) >> 3);
        break;
      }
    }
#endif
    lcp = min(lcp, cap);
    const int need = min_len + gate * (ro >= far1) + gate * (ro >= far2);
    if (lcp < need) continue;
    const int score = lcp * 1024 + (1023 - j);
    if (score > bs) {
      bs = score;
      bq = pos_r[c];
      bro = ro;
      blen = lcp;
      if (lcp == min(4 * kNDw, cap)) break;
    }
  }
  best_q[row + i] = bq;
  best_ro[row + i] = STAGE < 2 ? static_cast<int>(fold) : bro;
  best_len[row + i] = blen;
}
}  // namespace
extern "C" int otz_match_depth(const int* msk, const int* msp,
                               const int* rank_s, const int* dw_s,
                               const int* end, int* best_q, int* best_ro,
                               int* best_len, int B, int n, int depth,
                               int ro_cap, int fence, int pad_front,
                               int min_len, int gate, int far1, int far2,
                               int n_dw, void* stream) {
  k1<<<dim3((n + 255) / 256, B), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      msk, msp, rank_s, dw_s, end, best_q, best_ro, best_len, n, depth,
      ro_cap, fence, pad_front, min_len, gate, far1, far2);
  return static_cast<int>(cudaGetLastError());
}
"""

# the walk before its redesign, behind the entry point's new signature
_WALK_BEFORE = r"""
#include <cuda_runtime.h>
namespace {
__global__ void walk(const int* __restrict__ nxt, const int* __restrict__ end,
                     unsigned char* __restrict__ mask, int B, int n,
                     int n_blocks, int fence, int pad_front) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * n_blocks) return;
  const int b = t / n_blocks;
  const int k = t - b * n_blocks;
  const int* row = nxt + static_cast<size_t>(b) * n;
  unsigned char* mrow = mask + static_cast<size_t>(b) * n;
  const int base = pad_front + k * fence;
  const int blk_end = min(max(end[b] - base, 0), fence);
  int cur = 0;
  while (cur < blk_end) {
    mrow[base + cur] = 1;
    const int local = min(max(row[base + cur] - base, 1), fence);
    cur = max(local, cur + 1);
  }
}
}  // namespace
extern "C" int otz_fence_walk(const int* nxt, const int* end,
                              unsigned char* mask, int* counts, int B, int n,
                              int n_blocks, int fence, int pad_front,
                              void* stream) {
  walk<<<(B * n_blocks + 127) / 128, 128, 0,
         static_cast<cudaStream_t>(stream)>>>(nxt, end, mask, B, n, n_blocks,
                                             fence, pad_front);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_all(variants: dict[str, tuple[str, list[str]]], out_dir: str):
    """{name: (source path, nvcc defines)} -> {name: loaded library}, one
    nvcc a variant, all started together; prints ptxas's lines."""
    nvcc = _lib._nvcc()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (src, defines) in variants.items():
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, "-gencode", _lib.ARCH, "-std=c++17", "-O3", "-Xptxas=-v",
             "-Xcompiler", "-fPIC", "-shared", *defines, src, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}: {out}")
        regs = [ln.strip() for ln in out.splitlines()
                if "Used" in ln or "spill" in ln]
        print(f"build {name}: " + " | ".join(regs), flush=True)
        lib = ctypes.CDLL(so)
        for fn, argtypes in _lib._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


SASS_OPS = ("LDG", "LDS", "STG", "STS", "BRA", "BAR", "SHFL")


def sass_summary(so: str, kernel: str) -> str:
    """Static counts of `kernel`'s SASS in `so` (``cuobjdump -sass``): its
    instructions and those of each class of ``SASS_OPS``."""
    tool = os.path.join(os.path.dirname(_lib._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return "cuobjdump not found"
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True).stdout
    body, inside = [], False
    for ln in out.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
        elif inside and "/*" in ln and ";" in ln:
            body.append(ln.split("*/", 1)[1].split(";")[0].split())
    ops = [w[1] if w[0].startswith("@") else w[0] for w in body if w]
    counts = {op: sum(o.startswith(op) for o in ops) for op in SASS_OPS}
    return f"{len(ops)} instructions, " + ", ".join(
        f"{op} {k}" for op, k in counts.items())


def cuda_ms(fn, reps: int = 5) -> float:
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


def k1_call(lib, msk, msp, rank_s, dw_s, end, depth: int):
    bsz, n = msk.shape
    out = tuple(torch.empty_like(msk) for _ in range(3))
    rc = lib.otz_match_depth(
        msk.data_ptr(), msp.data_ptr(), rank_s.data_ptr(), dw_s.data_ptr(),
        end.data_ptr(), *(t.data_ptr() for t in out), bsz, n, depth, RING,
        FENCE, PAD_FRONT, LZ_MATCH_MIN_LEN, _FAR_GATE, FAR_RO_1, FAR_RO_2,
        N_DW, torch.cuda.current_stream().cuda_stream)
    _lib.check(rc, "otz_match_depth")
    return out


def walk_call(lib, nxt, end, counts: bool, before: bool = False):
    """The walk through `lib`; `before`: the kernel before its redesign,
    which needs a zeroed mask and leaves the counts to a row sum."""
    bsz, n = nxt.shape
    mask = (torch.zeros if before else torch.empty)(
        (bsz, n), dtype=torch.bool, device=nxt.device)
    n_items = torch.zeros(bsz, dtype=torch.int32, device=nxt.device) \
        if counts and not before else None
    rc = lib.otz_fence_walk(
        nxt.data_ptr(), end.data_ptr(), mask.data_ptr(),
        n_items.data_ptr() if n_items is not None else None, bsz, n,
        -(-(n - PAD_FRONT) // FENCE), FENCE, PAD_FRONT,
        torch.cuda.current_stream().cuda_stream)
    _lib.check(rc, "otz_fence_walk")
    if counts and before:
        n_items = mask.sum(dim=1).int()
    return mask, n_items


def main(argv=None) -> int:
    import chip_smoke  # the smoke's data, from the repository root
    from orz_tpu_torch.ops import batched as ob

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA GPU", file=sys.stderr)
        return 1
    src_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "csrc")
    out_dir = os.path.join(_lib._BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    before = os.path.join(out_dir, "k1_before.cu")
    walk_before = os.path.join(out_dir, "walk_before.cu")
    for path, text in ((before, _K1_BEFORE), (walk_before, _WALK_BEFORE)):
        with open(path, "w") as f:
            f.write(text)
    variants = {f"k1_before_{s}": (before, [f"-DSTAGE={i}"])
                for i, s in enumerate(("keys", "query_dwords", "full",
                                       "grouped"))}
    variants["k1_t256"] = (os.path.join(src_dir, "match_depth.cu"), [])
    variants["walk_before"] = (walk_before, [])
    variants["walk_speculative"] = (os.path.join(src_dir, "fence_walk.cu"),
                                    [])
    for name, src, old, new in PATCHES:
        with open(os.path.join(src_dir, src)) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"kernel_variants: {name}: {old!r} not found")
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        variants[name] = (path, [])
    libs = build_all(variants, out_dir)
    for name, kernel in (("k1_before_full", "k1"),
                         ("k1_t256", "match_depth_kernel"),
                         ("walk_before", "walk"),
                         ("walk_speculative", "fence_walk_kernel")):
        print(f"sass {name} ({kernel}): "
              + sass_summary(libs[name]._name, kernel), flush=True)

    data = chip_smoke.make_data(args.seed, 32 * chip_smoke.MIB)
    bufs, lens = chip_smoke._batch_inputs(data, 8 * chip_smoke.MIB, 4)
    n = bufs.shape[1]
    p = torch.arange(n, device=bufs.device)
    valid = (p >= PAD_FRONT) & (p < (PAD_FRONT + lens).view(-1, 1))
    ba = ob.byte_arrays_b(bufs)
    cand = ob.candidate_arrays_b(ba, ob.context_ranks_b(ba, valid), valid)
    end = (PAD_FRONT + lens).int()
    times = {}
    for depth in (8, 32):
        want = match_depth_plain(*cand, end, depth)
        for name, lib in libs.items():
            if not name.startswith("k1_"):
                continue
            got = k1_call(lib, *cand, end, depth)
            real = not name.endswith(("_keys", "_query_dwords", "_stage"))
            if real and not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name} d{depth}: differs from plain")
            ms = cuda_ms(lambda: k1_call(lib, *cand, end, depth))
            times[f"{name}_d{depth}"] = ms
            print(f"{name} depth {depth}: {ms:.3f} ms"
                  + (", equal to plain" if real else ""), flush=True)
    del cand, ba

    an = ob.analyze_b(bufs, lens, 32)
    nxt = ob.decisions_b(an, lens, n).nxt
    del an
    want = fence_walk_mask_plain(nxt, lens)
    for name in ("walk_before", "walk_speculative", "walk_serial"):
        for counts in (False, True):
            call = (lambda: walk_call(libs[name], nxt, end, counts,
                                      name == "walk_before"))
            mask, n_items = call()
            if not torch.equal(mask, want) or (
                    counts and not torch.equal(n_items, want.sum(1).int())):
                raise AssertionError(f"{name}: differs from plain")
            ms = cuda_ms(call)
            key = f"{name}{'_counts' if counts else ''}"
            times[key] = ms
            print(f"{key}: {ms:.3f} ms, equal to plain", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
