"""Golden (reference-exact, bounds-checked, slow) model of the ORZ format,
copied for the port from ``orz_tpu/golden/``.

It pins the bit-level semantics of every stage of the codec.  It is
deliberately written for clarity and exactness, not speed; the native C++
backend (``orz_tpu_torch.native``) is held to it byte for byte.  It uses
the ORZ constants (``orz_tpu_torch/constants.py``), never the OTZ ones
(``spec.py``), and the port's one bit writer (``bitio.py``).
"""

from orz_tpu_torch.golden.lz import GoldenLZDecoder, GoldenLZEncoder  # noqa: F401
