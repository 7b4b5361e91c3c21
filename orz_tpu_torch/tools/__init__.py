"""Probes of the port: ``python -m orz_tpu_torch.tools.<name>``."""
