"""Command-line interface of the port, ``orz_tpu/cli.py`` with ``-b gpu``
in the place of ``-b tpu``.

    python -m orz_tpu_torch.cli encode [-s] [-l 0..3] [-b gpu|auto|native|golden] [-p N] [--checkpoint STATE.json] [ipath] [opath]
    python -m orz_tpu_torch.cli decode [-s] [-b gpu|auto|native|golden] [ipath] [opath]

Paths default to stdin/stdout; progress and statistics go to stderr.

- ``-b gpu`` (the default) is the device engine: encode writes the ORZT
  container through ``torch_encode``, ``-p N`` segments per device call
  (default 2, as ``orz_tpu.cli`` passes to ``tpu_encode``).  It runs on the
  card and exits 1 without CUDA; ``main(argv, device="cpu")`` runs it on
  the CPU.
- ``-b native|golden|auto`` are the host codecs: encode writes an
  orz-compatible stream, or with ``-p N`` the ORZP container over N
  worker threads (``pcontainer.pencode``).  ``auto`` is native, or golden
  where the native build fails.  They are numpy and ctypes, and load no
  torch (unless they decode an ORZT stream).
- ``--checkpoint`` (file paths only: a resume seeks both files) writes the
  multi-stream container of the backend (ORZT, or ORZP) with a
  segment-granular resume sidecar; under ``-b gpu`` each 8 MiB segment goes
  through the per-segment staged encoder, ``-p N`` (default 2) at a time.
- decode reads all three streams, told apart by their first bytes: ORZT
  through the native OTZ decoder, ORZP and orz-compatible streams through
  the host backend (``auto`` under ``-b gpu``, as ``-b tpu`` does in the
  JAX package).

For the same input, backend, level and ``-p`` every file is byte-identical
to ``python -m orz_tpu.cli``'s.
"""

from __future__ import annotations

import argparse
import sys
from typing import TYPE_CHECKING

from orz_tpu_torch import checkpoint, container, pcontainer
from orz_tpu_torch.cfg import LEVEL_PRESETS, cfg_from_level
from orz_tpu_torch.ioutil import CountRead, CountWrite
from orz_tpu_torch.progress import SilentProgressLogger, SimpleProgressLogger

if TYPE_CHECKING:
    import torch

BACKENDS = ("gpu", "auto", "native", "golden")


def get_backend(name: str):
    """A host backend by name; "gpu" stands for the device engine."""
    if name == "golden":
        return container.GoldenBackend()
    if name == "native":
        from orz_tpu_torch.native import NativeBackend

        return NativeBackend()
    if name == "gpu":
        return "gpu"  # the device engine: the ORZT container paths
    if name == "auto":
        from orz_tpu_torch import default_backend

        return default_backend()
    raise ValueError(f"unknown backend: {name}")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m orz_tpu_torch.cli",
        description="a ROLZ data compressor: the OTZ device encoder on a "
                    "CUDA GPU, and the orz-compatible host codecs")
    sub = parser.add_subparsers(dest="command", required=True)
    backend_help = ("codec backend: gpu (the device engine) | auto | native "
                    "| golden (the host codecs)")

    p_enc = sub.add_parser("encode", help="Encode")
    p_enc.add_argument("-s", "--silent", action="store_true",
                       help="Run silently")
    p_enc.add_argument("-l", "--level", type=int, default=2,
                       help="Set compression level (0..3)")
    p_enc.add_argument("-b", "--backend", default="gpu", choices=BACKENDS,
                       help=backend_help)
    p_enc.add_argument("-p", "--parallel", type=int, default=0, metavar="N",
                       help="gpu: segments per device call (default 2); "
                            "host backends: the ORZP container over N "
                            "workers")
    p_enc.add_argument("--checkpoint", metavar="STATE.json", default=None,
                       help="segment-granular resume sidecar (requires file "
                            "paths; implies the multi-stream container)")
    p_enc.add_argument("ipath", nargs="?", default=None,
                       help="Source file name, default to stdin")
    p_enc.add_argument("opath", nargs="?", default=None,
                       help="Target file name, default to stdout")

    p_dec = sub.add_parser("decode", help="Decode")
    p_dec.add_argument("-s", "--silent", action="store_true",
                       help="Run silently")
    p_dec.add_argument("-b", "--backend", default="gpu", choices=BACKENDS,
                       help=backend_help)
    p_dec.add_argument("ipath", nargs="?", default=None)
    p_dec.add_argument("opath", nargs="?", default=None)
    return parser


def _checkpointed_encode(args, backend, logger, device) -> None:
    """encode --checkpoint, which opens the files itself: a resume must
    find the target as the crashed run left it.  Each segment is encoded
    on its own, -p N (default 2) at a time: under -b gpu by the staged
    encoder into ORZT, as ``orz_tpu/cli.py`` does under -b tpu."""
    if backend == "gpu":
        from orz_tpu_torch.device import container as device_container
        from orz_tpu_torch.device.pipeline import encode_segment_staged
        from orz_tpu_torch.spec import CHUNK_INPUT_DEFAULT

        level = args.level
        encode_segment = (lambda seg: encode_segment_staged(
            seg, level, CHUNK_INPUT_DEFAULT, device=device))
        magic = pcontainer.TPU_MAGIC
        segment_size = device_container.DEFAULT_SEGMENT_SIZE
    else:
        cfg = cfg_from_level(args.level)
        encode_segment = (lambda seg:
                          container.encode_bytes(seg, cfg, backend))
        magic = pcontainer.PARALLEL_MAGIC
        segment_size = pcontainer.DEFAULT_SEGMENT_SIZE
    checkpoint.checkpointed_encode(
        args.ipath, args.opath, encode_segment, magic, segment_size,
        args.parallel or 2, args.checkpoint, logger)


def _encode(args, backend, fin, fout, logger, device) -> None:
    if backend == "gpu":
        from orz_tpu_torch.device.container import torch_encode

        torch_encode(fin, fout, level=args.level, batch=args.parallel or 2,
                     progress=logger, device=device)
    elif args.parallel:
        pcontainer.pencode(fin, fout, cfg_from_level(args.level), backend,
                           num_streams=args.parallel, progress=logger)
    else:
        container.encode(CountRead(fin), CountWrite(fout),
                         cfg_from_level(args.level), backend, logger)


def _decode(backend, fin, fout, logger) -> None:
    head = fin.read(pcontainer.MAGIC_LEN)
    stream = _PrefixedReader(head, fin)
    if head == pcontainer.TPU_MAGIC:
        from orz_tpu_torch.device.container import torch_decode

        torch_decode(stream, fout, progress=logger)
        return
    if backend == "gpu":
        backend = get_backend("auto")
    if head == pcontainer.PARALLEL_MAGIC:
        pcontainer.pdecode(stream, fout, backend, progress=logger)
    else:
        container.decode(CountRead(stream), CountWrite(fout), backend,
                         logger)


def main(argv=None, device: str | torch.device = "cuda") -> int:
    args = _parser().parse_args(argv)
    if args.backend == "gpu":  # the host backends load no torch
        import torch

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            print(f"{args.command} failed: the gpu backend needs a CUDA GPU "
                  f"(torch.cuda.is_available() is false)", file=sys.stderr)
            return 1
    if args.command == "encode":
        if args.level not in LEVEL_PRESETS:
            print(f"encode failed: invalid level: {args.level}",
                  file=sys.stderr)
            return 1
        if args.checkpoint and not (args.ipath and args.opath):
            print("encode --checkpoint requires file paths (resume seeks "
                  "both files)", file=sys.stderr)
            return 1
    logger = SilentProgressLogger() if args.silent else SimpleProgressLogger()
    try:
        backend = get_backend(args.backend)
    except Exception as e:
        print(f"backend init failed: {e}", file=sys.stderr)
        return 1

    fin = fout = None
    try:
        if args.command == "encode" and args.checkpoint:
            _checkpointed_encode(args, backend, logger, device)
            return 0
        fin = open(args.ipath, "rb") if args.ipath else sys.stdin.buffer
        fout = open(args.opath, "wb") if args.opath else sys.stdout.buffer
        if args.command == "encode":
            _encode(args, backend, fin, fout, logger, device)
        else:
            _decode(backend, fin, fout, logger)
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

    def readinto(self, buf) -> int:
        data = self.read(len(buf))
        buf[: len(data)] = data
        return len(data)


if __name__ == "__main__":
    sys.exit(main())
