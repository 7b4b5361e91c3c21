"""`idle_share.container` in the host-bound cells, where it moves `encode_MBps.host_bound`."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _alias  # noqa: E402

read = _alias.reader("idle_share.container")
