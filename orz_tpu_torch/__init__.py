"""PyTorch/CUDA port of the OTZ device encoder.

Layout:

- ``device/``: the batched encode (``batch.encode_segments_batch``: OTZ1 at
  l0/l1, the OTZ2 default from l2), the ORZT container entry points
  (``container.torch_encode`` / ``torch_decode``), the container framing
  (``pcontainer``) and the host helpers (``host``).
- ``ops/``: the torch bodies of the batched encoder, named after their JAX
  counterparts in ``orz_tpu/ops/batched.py`` (``batched``: FRONT, the
  analyses, MID, BACK; ``otz2``: the QUALITY steps and MID2).
- ``kernels/``: one wrapper per hand-written CUDA kernel, each with its
  plain torch version beside it and a launch counter.
- ``csrc/``: the CUDA sources, built with nvcc into one shared library at
  first use.
- ``spec.py``, ``bitio.py``: the format constants and knobs, and the bit
  writer.
- ``cli.py``: the command line (``python -m orz_tpu_torch.cli
  encode|decode -b gpu``), with ``checkpoint.py`` (``--checkpoint``) and
  ``progress.py`` (its progress loggers).
- ``tools/``: ``gather_probe.py``, the probe of the windowed gather.

The package imports nothing of the JAX package ``orz_tpu``: the format
constants, the bit writer, the container framing, the native decoder's
loader, the progress loggers and the checkpoint sidecar are copies
(``spec``, ``bitio``, ``device/pcontainer``, ``device/container``,
``progress``, ``checkpoint``), which ``tests/test_torch_host.py`` pins to
their originals.  The decoder itself is built from ``csrc/otz_core.cpp`` at the
repository root, the same source the JAX package builds.
"""
