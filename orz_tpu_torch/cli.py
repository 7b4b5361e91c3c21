"""Command-line interface of the port: ``orz_tpu/cli.py``'s device engine.

    python -m orz_tpu_torch.cli encode [-s] [-l 0..3] [-b gpu] [-p N] [--checkpoint STATE.json] [ipath] [opath]
    python -m orz_tpu_torch.cli decode [-s] [-b gpu] [ipath] [opath]

Paths default to stdin/stdout; progress and statistics go to stderr.
Encode writes the ORZT container through ``torch_encode``, ``-p N``
segments per device call (default 2, as ``orz_tpu.cli`` passes to
``tpu_encode``), or through ``checkpointed_encode`` with ``--checkpoint``
(file paths only: a resume seeks both files).  For the same input, level
and ``-p`` the file is byte-identical to ``python -m orz_tpu.cli encode -b
tpu``'s.  Decode reads ORZT through ``torch_decode`` (the native decoder).
The JAX package's host backends (golden, native, auto) and their streams
(orz-compatible, ORZP) are not ported: such a stream exits 1 with a
message that says so.

It runs on the card and exits 1 without CUDA; ``main(argv,
device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import torch

from orz_tpu_torch import checkpoint
from orz_tpu_torch.device import container
from orz_tpu_torch.device.pcontainer import MAGIC_LEN, PARALLEL_MAGIC, TPU_MAGIC
from orz_tpu_torch.progress import SilentProgressLogger, SimpleProgressLogger

LEVELS = (0, 1, 2, 3)
NOT_PORTED = ("the port decodes ORZT streams only; the host backends "
              "(golden, native, auto) are not ported")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m orz_tpu_torch.cli",
        description="the OTZ device encoder on a CUDA GPU")
    sub = parser.add_subparsers(dest="command", required=True)

    p_enc = sub.add_parser("encode", help="Encode")
    p_enc.add_argument("-s", "--silent", action="store_true",
                       help="Run silently")
    p_enc.add_argument("-l", "--level", type=int, default=2,
                       help="Set compression level (0..3)")
    p_enc.add_argument("-b", "--backend", default="gpu", choices=["gpu"],
                       help="codec backend: gpu (the device engine)")
    p_enc.add_argument("-p", "--parallel", type=int, default=0, metavar="N",
                       help="segments per device call (default 2)")
    p_enc.add_argument("--checkpoint", metavar="STATE.json", default=None,
                       help="segment-granular resume sidecar (requires file "
                            "paths)")
    p_enc.add_argument("ipath", nargs="?", default=None,
                       help="Source file name, default to stdin")
    p_enc.add_argument("opath", nargs="?", default=None,
                       help="Target file name, default to stdout")

    p_dec = sub.add_parser("decode", help="Decode")
    p_dec.add_argument("-s", "--silent", action="store_true",
                       help="Run silently")
    p_dec.add_argument("-b", "--backend", default="gpu", choices=["gpu"],
                       help="codec backend: gpu (the device engine)")
    p_dec.add_argument("ipath", nargs="?", default=None)
    p_dec.add_argument("opath", nargs="?", default=None)
    return parser


def main(argv=None, device: str | torch.device = "cuda") -> int:
    args = _parser().parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"{args.command} failed: the gpu backend needs a CUDA GPU "
              f"(torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    if args.command == "encode":
        if args.level not in LEVELS:
            print(f"encode failed: invalid level: {args.level}",
                  file=sys.stderr)
            return 1
        if args.checkpoint and not (args.ipath and args.opath):
            print("encode --checkpoint requires file paths (resume seeks "
                  "both files)", file=sys.stderr)
            return 1
    logger = SilentProgressLogger() if args.silent else SimpleProgressLogger()

    fin = fout = None
    try:
        if args.command == "encode" and args.checkpoint:
            checkpoint.checkpointed_encode(
                args.ipath, args.opath, args.checkpoint, level=args.level,
                batch=args.parallel or 2, progress=logger, device=device)
            return 0
        fin = open(args.ipath, "rb") if args.ipath else sys.stdin.buffer
        fout = open(args.opath, "wb") if args.opath else sys.stdout.buffer
        if args.command == "encode":
            container.torch_encode(fin, fout, level=args.level,
                                   batch=args.parallel or 2,
                                   progress=logger, device=device)
        else:
            head = fin.read(MAGIC_LEN)
            if head != TPU_MAGIC:
                what = ("an ORZP stream" if head == PARALLEL_MAGIC else
                        "not an ORZT stream (an orz-compatible stream, or no "
                        "stream at all)")
                print(f"decode failed: {what}: {NOT_PORTED}",
                      file=sys.stderr)
                return 1
            container.torch_decode(_PrefixedReader(head, fin), fout,
                                   progress=logger)
        fout.flush()
    except (OSError, ValueError, EOFError) as e:
        print(f"{args.command} failed: {e}", file=sys.stderr)
        return 1
    finally:
        if fin is not None and args.ipath:
            fin.close()
        if fout is not None and args.opath:
            fout.close()
    return 0


class _PrefixedReader:
    """A reader that replays an already-consumed prefix."""

    def __init__(self, prefix: bytes, inner):
        self.prefix = prefix
        self.inner = inner

    def read(self, n: int = -1) -> bytes:
        if not self.prefix:
            return self.inner.read(n)
        if 0 <= n < len(self.prefix):
            out, self.prefix = self.prefix[:n], self.prefix[n:]
            return out
        out, self.prefix = self.prefix, b""
        return out + (self.inner.read(n - len(out) if n >= 0 else -1) or b"")


if __name__ == "__main__":
    sys.exit(main())
