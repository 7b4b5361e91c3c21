"""Multi-GPU and multi-process scaling of the OTZ encoder, as in
``orz_tpu/parallel/``.

The stream format is sequentially state-dependent end to end, so the
parallel axis that preserves it is block data parallelism: the ORZT
container splits the input into independent segments, a batch of them
splits over a 1-D mesh of devices (``mesh.py``), and across processes the
segments stripe round-robin, their payloads gathered in file order over
``torch.distributed`` (``distributed.py``).  There is no tensor or pipeline
parallelism: each segment's state is its own.
"""

from orz_tpu_torch.parallel.mesh import (  # noqa: F401
    batched_encode,
    blocks_mesh,
    mesh_encode_segments,
    mesh_encode_segments_staged,
)
