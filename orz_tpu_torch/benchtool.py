"""Competitive benchmark harness (reference benchmark-tool/src/main.rs),
copied for the port from ``orz_tpu/benchtool.py``.

Benchmarks the host codecs at l0/l1/l2 and the device encoder at l2 (its
ORZT stream, decoded by the native OTZ decoder) against other codecs
available on the system (subprocess CLIs where installed, Python stdlib
codecs otherwise), timing the best of N rounds, verifying round trips by
MD5, and emitting a markdown table sorted by compressed size.

    python -m orz_tpu_torch.benchtool <bench-file> [--rounds 3] [--backend auto]

The device row runs on the card; without CUDA the tool exits 1, as the
CLI does.  ``main(argv, device="cpu")`` runs the device row on the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import shutil
import subprocess
import sys
import time

import torch


def _cli_codec(enc_cmd, dec_cmd):
    def enc(data: bytes) -> bytes:
        return subprocess.run(enc_cmd, input=data, capture_output=True, check=True).stdout

    def dec(data: bytes) -> bytes:
        return subprocess.run(dec_cmd, input=data, capture_output=True, check=True).stdout

    return enc, dec


def _orz_codec(level: int, backend):
    from orz_tpu_torch import cfg_from_level
    from orz_tpu_torch.container import decode_bytes, encode_bytes

    cfg = cfg_from_level(level)
    return (lambda d: encode_bytes(d, cfg, backend)), (lambda d: decode_bytes(d, backend))


def build_codecs(backend, device="cuda"):
    import bz2 as _bz2
    import lzma as _lzma
    import zlib as _zlib

    from orz_tpu_torch.device.container import torch_decode_bytes, torch_encode_bytes

    codecs = [(f"**orz-tpu -l{lv}**",) + _orz_codec(lv, backend) for lv in (0, 1, 2)]
    codecs.append((
        "**orz-tpu -b gpu -l2**",
        lambda d: torch_encode_bytes(d, level=2, device=device),
        torch_decode_bytes,
    ))
    if shutil.which("gzip"):
        codecs.append(("gzip -6",) + _cli_codec(["gzip", "-6", "-c"], ["gzip", "-d", "-c"]))
    else:
        codecs.append(("gzip -6 (zlib)", lambda d: _zlib.compress(d, 6), _zlib.decompress))
    if shutil.which("bzip2"):
        codecs.append(("bzip2 -9",) + _cli_codec(["bzip2", "-9", "-c"], ["bzip2", "-d", "-c"]))
    else:
        codecs.append(("bzip2 -9 (py)", lambda d: _bz2.compress(d, 9), _bz2.decompress))
    if shutil.which("xz"):
        codecs.append(("xz -6",) + _cli_codec(["xz", "-6", "-c", "-T1"], ["xz", "-d", "-c"]))
    else:
        codecs.append(("xz -6 (py)", lambda d: _lzma.compress(d, preset=6), _lzma.decompress))
    if shutil.which("zstd"):
        codecs.append(("zstd -19",) + _cli_codec(["zstd", "-19", "-c"], ["zstd", "-d", "-c"]))
    if shutil.which("brotli"):
        codecs.append(("brotli -9",) + _cli_codec(["brotli", "-9", "-c"], ["brotli", "-d", "-c"]))
    return codecs


def bench_one(name, enc, dec, data: bytes, rounds: int):
    """Best-of-N timings with MD5 round-trip verification on every round
    (the reference verifies per round, benchmark-tool/src/main.rs:104-108)."""
    src_md5 = hashlib.md5(data).hexdigest()
    best_enc = best_dec = float("inf")
    size = None
    for _ in range(rounds):
        t0 = time.perf_counter()
        compressed = enc(data)
        t1 = time.perf_counter()
        decoded = dec(compressed)
        t2 = time.perf_counter()
        if hashlib.md5(decoded).hexdigest() != src_md5:
            raise RuntimeError(f"{name}: round-trip MD5 mismatch")
        size = len(compressed)
        best_enc = min(best_enc, t1 - t0)
        best_dec = min(best_dec, t2 - t1)
    return size, best_enc, best_dec


def markdown_table(rows):
    headers = ["name", "compressed size", "encode time", "decode time"]
    widths = [max(len(h), max((len(r[i]) for r in rows), default=0)) for i, h in enumerate(headers)]
    out = []
    out.append("|" + "|".join(h.ljust(w) for h, w in zip(headers, widths)) + "|")
    out.append("|" + "|".join("-" * w for w in widths) + "|")
    for r in rows:
        out.append("|" + "|".join(c.ljust(w) for c, w in zip(r, widths)) + "|")
    return "\n".join(out)


def main(argv=None, device: str | torch.device = "cuda") -> int:
    ap = argparse.ArgumentParser(prog="python -m orz_tpu_torch.benchtool")
    ap.add_argument("bench_file")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--backend", default="auto",
                    help="host backend of the orz rows: auto|native|golden")
    ap.add_argument("--only", default=None, help="comma-separated substring filter on codec names")
    args = ap.parse_args(argv)

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench failed: the gpu backend needs a CUDA GPU "
              "(torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    from orz_tpu_torch.cli import get_backend

    backend = get_backend(args.backend)
    with open(args.bench_file, "rb") as f:
        data = f.read()

    rows = []
    for name, enc, dec in build_codecs(backend, device):
        if args.only and not any(s in name for s in args.only.split(",")):
            continue
        try:
            size, te, td = bench_one(name, enc, dec, data, args.rounds)
        except Exception as e:
            print(f"{name}: FAILED ({e})", file=sys.stderr)
            continue
        print(f"size: {size}, enc_time: {te:.3f}s, dec_time: {td:.3f}s  [{name}]", file=sys.stderr)
        rows.append((name, f"{size:,}", f"{te:.3f}s", f"{td:.3f}s"))

    rows.sort(key=lambda r: int(r[1].replace(",", "")))
    print(markdown_table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
