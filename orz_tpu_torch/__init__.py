"""PyTorch/CUDA port of the OTZ device encoder (the OTZ1 slice).

Layout:

- ``device/``: the batched encode (``batch.encode_segments_batch``), the ORZT
  container entry points (``container.torch_encode``) and the host helpers
  copied from the JAX package's jax-importing modules (``host``).
- ``ops/``: the torch bodies of the batched encoder, named after their JAX
  counterparts in ``orz_tpu/ops/batched.py``.
- ``kernels/``: one wrapper per hand-written CUDA kernel, each with its
  plain torch version beside it and a launch counter.
- ``csrc/``: the CUDA sources, built with nvcc into one shared library at
  first use.

The format, the sequential oracle and the decoder are shared with the JAX
package (``orz_tpu.device.spec``, ``refcodec``, ``container.tpu_decode``);
this package never imports jax.
"""
