"""Probe: torch gather costs by index pattern + the CUDA windowed gather.

The port's counterpart of ``tools/gather_probe.py``.  For m = 2^m_log2
outputs from n = 4m int32s (the JAX probe's arrays, drawn from numpy in its
order), it prints the times of ``src[idx]`` with random and with sorted
indices, the sorted scatter, ``torch.take`` with sorted indices, and the
windowed gather (P1, ``kernels/windowed_gather.py``) on ascending indices
of stride 1..5 (the density of item starts), with ``ok=`` its equality
with ``src[idx]``.  Times are CUDA-event means of 5 calls after a warm-up.

    python -m orz_tpu_torch.tools.gather_probe [m_log2]

It runs on the card and exits 1 without CUDA; ``main(argv,
device="cpu")`` runs it on the CPU (the wrappers' plain versions, timed by
the host clock).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from orz_tpu_torch.kernels.windowed_gather import BLK, WIN, windowed_gather


def probe_data(m_log2: int) -> dict[str, np.ndarray]:
    """The JAX probe's arrays (seed 0): src, sorted and random indices, and
    the ascending stride-1..5 indices with each block's first as its base."""
    m = 1 << m_log2
    n = 4 * m
    rng = np.random.default_rng(0)
    src = rng.integers(0, 1 << 30, n, dtype=np.int32)
    idx_sorted = np.sort(rng.integers(0, n, m)).astype(np.int32)
    idx_rand = rng.integers(0, n, m, dtype=np.int32)
    stride = np.minimum(np.cumsum(rng.integers(1, 6, m)), n - 1).astype(
        np.int32)
    return {"src": src, "idx_sorted": idx_sorted, "idx_rand": idx_rand,
            "idx": stride, "base": stride.reshape(-1, BLK)[:, 0].copy()}


def edge_cases(idx: np.ndarray, base: np.ndarray,
               n: int) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """(idx, base) pairs that pin P1's semantics, made from ascending
    in-window ones: ``in_window`` as given; ``fill``, each block's indices
    moved to the window's edges (WIN + 1 and WIN below its aligned base:
    0 and the wrapped first word; its last word and one past it: 0);
    ``wrap``, every base 300 above its block's first index; ``clamp``, a
    last block whose window runs past the end of src."""
    origin = (base.astype(np.int64) // 128 * 128)[:, None]
    fill = idx.reshape(-1, BLK).copy()
    fill[:, :2] = origin - WIN + np.array([-1, 0])
    fill[:, -2:] = origin + WIN + np.array([-1, 0])
    clamp = idx.reshape(-1, BLK).copy()
    clamp[-1] = np.arange(n - BLK, n)
    clamp_base = base.copy()
    clamp_base[-1] = n - BLK
    return {"in_window": (idx, base), "fill": (fill.reshape(-1), base),
            "wrap": (idx, base + 300),
            "clamp": (clamp.reshape(-1), clamp_base)}


def timeit(fn, device: torch.device, reps: int = 5) -> float:
    """Mean seconds per call of fn() after one warm-up call: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3 / reps


def main(argv=None, device: str | torch.device = "cuda") -> int:
    ap = argparse.ArgumentParser(prog="gather_probe",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("m_log2", nargs="?", type=int, default=21)
    args = ap.parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("gather_probe: needs a CUDA GPU (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 1
    if args.m_log2 < 11:
        print(f"gather_probe: m_log2 must be at least 11 (one block of "
              f"{BLK})", file=sys.stderr)
        return 1
    d = {k: torch.from_numpy(v).to(device)
         for k, v in probe_data(args.m_log2).items()}
    src, idx_sorted, idx_rand = d["src"], d["idx_sorted"], d["idx_rand"]
    m = idx_sorted.shape[0]

    def ms(fn) -> str:
        return f"{timeit(fn, device) * 1e3:8.2f} ms"

    print(f"m=2^{args.m_log2} gathers from n=4m ({device.type}):")
    print(f"  torch gather random : {ms(lambda: src[idx_rand])}")
    print(f"  torch gather sorted : {ms(lambda: src[idx_sorted])}")
    vals = src[:m]

    def scatter():
        out = torch.zeros_like(src)
        out[idx_sorted] = vals
        return out

    print(f"  torch scatter sorted: {ms(scatter)}")
    idx_long = idx_sorted.long()  # torch.take takes int64 indices only
    print(f"  torch take sorted   : {ms(lambda: torch.take(src, idx_long))}")
    idx, base = d["idx"], d["base"]
    blocks = idx.view(-1, BLK)
    span = int((blocks[:, -1] - blocks[:, 0]).max())
    print(f"  windowed idx span max {span} (WIN={WIN})")
    if span >= WIN:  # the indices break the kernel's contract
        return 0
    ok = torch.equal(windowed_gather(src, idx, base), src[idx])
    print(f"  windowed gather     : "
          f"{ms(lambda: windowed_gather(src, idx, base))} ok={ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
