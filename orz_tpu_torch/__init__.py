"""PyTorch/CUDA port of orz-tpu: the OTZ device encoder and the host codecs.

Layout:

- ``device/``: the batched encode (``batch.encode_segments_batch``: OTZ1 at
  l0/l1, the OTZ2 default from l2), the per-segment staged encode
  (``pipeline.encode_segment_staged``, ``encode_segment_device``), the
  ORZT container entry points (``container.torch_encode`` /
  ``torch_decode``), the batched container loop (``pcontainer``) and the
  host helpers (``host``).
- ``parallel/``: a batch split over CUDA devices (``mesh``) and the
  striped multi-process encode over ``torch.distributed``
  (``distributed``).
- ``ops/``: the torch bodies of the batched encoder, named after their JAX
  counterparts in ``orz_tpu/ops/batched.py`` (``batched``: FRONT, the
  analyses, MID, BACK; ``otz2``: the QUALITY steps and MID2).
- ``kernels/``: one wrapper per hand-written CUDA kernel, each with its
  plain torch version beside it and a launch counter.
- ``csrc/``: the CUDA sources, built with nvcc into one shared library at
  first use.
- ``spec.py``, ``bitio.py``: the OTZ format constants and knobs, and the bit
  writer and reader.
- The host codecs of the orz-compatible stream, numpy and ctypes as in the
  JAX package: ``cfg.py`` and ``constants.py`` (the ORZ format's own
  constants, kept apart from ``spec.py``), ``golden/`` (the reference-exact
  Python model), ``native/`` (the C++ codec ``csrc/orz_core.cpp`` at the
  repository root), ``container.py`` (the orz stream) and ``pcontainer.py``
  (the ORZP and ORZT multi-stream framing), over ``ioutil.py``.
- ``cli.py``: the command line (``python -m orz_tpu_torch.cli
  encode|decode -b gpu|auto|native|golden``), with ``checkpoint.py``
  (``--checkpoint``) and ``progress.py`` (its progress loggers);
  ``benchtool.py``, the competitive benchmark.
- ``tools/``: ``gather_probe.py``, the probe of the windowed gather.

The package imports nothing of the JAX package ``orz_tpu``: what it needs
of it is copied, and ``tests/test_torch_host.py`` and
``tests/test_torch_hostcodec.py`` pin each copy to its original.  The C++
sources ``csrc/orz_core.cpp`` and ``csrc/otz_core.cpp`` at the repository
root are shared with the JAX package.

Public API, as ``orz_tpu``'s (reference src/lib.rs:22-24): ``encode``,
``decode``, ``encode_bytes``, ``decode_bytes`` over a host backend,
``LZCfg``, ``LEVEL_PRESETS``, ``cfg_from_level``, ``CountRead``,
``CountWrite``, the progress loggers and ``default_backend``.  The device
encoder's entry points are ``device.container.torch_encode`` and
``torch_decode``.
"""

from orz_tpu_torch.cfg import LEVEL_PRESETS, LZCfg, cfg_from_level  # noqa: F401
from orz_tpu_torch.container import decode, decode_bytes, encode, encode_bytes  # noqa: F401
from orz_tpu_torch.ioutil import CountRead, CountWrite  # noqa: F401
from orz_tpu_torch.progress import (  # noqa: F401
    ProgressLogger,
    SilentProgressLogger,
    SimpleProgressLogger,
)


def default_backend():
    """The fastest available correct host backend: native C++ if it builds,
    otherwise the golden Python model."""
    try:
        from orz_tpu_torch.native import NativeBackend

        return NativeBackend()
    except Exception:
        from orz_tpu_torch.container import GoldenBackend

        return GoldenBackend()
