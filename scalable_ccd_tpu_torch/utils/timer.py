"""Wall-clock timer.

The port's copy of ``scalable_ccd_tpu/utils/timer.py`` (the reference's
``steady_clock`` Timer, ``src/scalable_ccd/utils/timer.hpp:7-55``).  PyTorch
returns before the device finishes, so a caller timing device work calls
``torch.cuda.synchronize()`` before ``stop()``, as the reference's cudaEvent
timer (``cuda/utils/timer.cuh:8-47``) synchronizes on its stream.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self) -> None:
        self._start = 0.0
        self._elapsed = 0.0
        self._running = False

    def start(self) -> None:
        self._start = time.perf_counter()
        self._running = True

    def stop(self) -> None:
        if self._running:
            self._elapsed = time.perf_counter() - self._start
            self._running = False

    def get_elapsed_s(self) -> float:
        return self._elapsed

    def get_elapsed_ms(self) -> float:
        return self._elapsed * 1e3

    def get_elapsed_us(self) -> float:
        return self._elapsed * 1e6

    def __enter__(self) -> "Timer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
