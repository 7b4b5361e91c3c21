"""The OTZ segment codec on torch.

``refcodec.py`` is the format's specification: the sequential numpy model
of an OTZ segment (``encode_segment_ref``, ``decode_segment_ref``), which
the device encoders here (``batch.py``, ``pipeline.py``) must equal byte
for byte and the decoders must invert.
"""

from orz_tpu_torch.spec import OTZ_MAGIC  # noqa: F401
