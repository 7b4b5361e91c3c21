"""Progress logging, copied for the port from ``orz_tpu/progress.py``
(reference src/progress.rs).

Same trait shape as the reference: set_is_encode / log / finish.  `log` is
called once per processed block with cumulative byte counts; `finish` prints
the final size/ratio/speed/time statistics to stderr.
``tests/test_torch_host.py`` holds the lines to the original's.
"""

from __future__ import annotations

import sys
import time


class ProgressLogger:
    def set_is_encode(self, is_encode: bool) -> None:
        raise NotImplementedError

    def log(self, num_input_bytes: int, num_output_bytes: int) -> None:
        raise NotImplementedError

    def finish(self, num_input_bytes: int, num_output_bytes: int) -> None:
        raise NotImplementedError


class SilentProgressLogger(ProgressLogger):
    def set_is_encode(self, is_encode: bool) -> None:
        pass

    def log(self, num_input_bytes: int, num_output_bytes: int) -> None:
        pass

    def finish(self, num_input_bytes: int, num_output_bytes: int) -> None:
        pass


class SimpleProgressLogger(ProgressLogger):
    """Per-block MB/s lines + final statistics (reference src/progress.rs:23-98)."""

    def __init__(self, stream=None):
        self.is_encode = True
        self.start_time = time.monotonic()
        self.update_time = self.start_time
        self.cur_in = 0
        self.cur_out = 0
        self.stream = stream if stream is not None else sys.stderr

    def set_is_encode(self, is_encode: bool) -> None:
        self.is_encode = is_encode

    def log(self, num_input_bytes: int, num_output_bytes: int) -> None:
        now = time.monotonic()
        dt_us = max((now - self.update_time) * 1e6, 1e-9)
        ibs = num_input_bytes - self.cur_in
        obs = num_output_bytes - self.cur_out
        if self.is_encode:
            print(f"encode: {ibs} bytes => {obs} bytes, {ibs / dt_us:.3f} MB/s", file=self.stream)
        else:
            print(f"encode: {obs} bytes <= {ibs} bytes, {obs / dt_us:.3f} MB/s", file=self.stream)
        self.cur_in = num_input_bytes
        self.cur_out = num_output_bytes
        self.update_time = now

    def finish(self, num_input_bytes: int, num_output_bytes: int) -> None:
        self.cur_in = num_input_bytes
        self.cur_out = num_output_bytes
        self.update_time = time.monotonic()
        dt_us = max((self.update_time - self.start_time) * 1e6, 1e-9)
        ibs, obs = self.cur_in, self.cur_out
        if self.is_encode:
            ratio = obs * 100.0 / ibs if ibs else 0.0
            mbps = ibs / dt_us
            size_line = f"{ibs} bytes => {obs} bytes"
        else:
            ratio = ibs * 100.0 / obs if obs else 0.0
            mbps = obs / dt_us
            size_line = f"{obs} bytes <= {ibs} bytes"
        print("statistics:", file=self.stream)
        print(f"  size:  {size_line}", file=self.stream)
        print(f"  ratio: {ratio:.2f}%", file=self.stream)
        print(f"  speed: {mbps:.3f} MB/s", file=self.stream)
        print(f"  time:  {dt_us * 1e-6:.3f} sec", file=self.stream)
