"""Console progress bar with a windows/s suffix (port of
``evflow/utils/progress.py``)."""

from __future__ import annotations

import sys
import time

__all__ = ["ProgressBar"]


class ProgressBar:
    """Minimal in-place progress bar: ``name |####----| 50% 123.4 Hz``."""

    def __init__(self, name: str, max: int = 100, width: int = 30, stream=None):
        self.name = name
        self.max = int(max) if int(max) > 0 else 1
        self.width = width
        self.n = 0
        self.t0 = time.time()
        self.stream = stream or sys.stderr

    def next(self, k: int = 1):
        self.n += k
        self._render()

    def _render(self):
        frac = min(1.0, self.n / self.max)
        filled = int(frac * self.width)
        hz = self.n / max(1e-9, time.time() - self.t0)
        bar = "#" * filled + "-" * (self.width - filled)
        self.stream.write(f"\r{self.name} |{bar}| {frac * 100:3.0f}% {hz:8.1f} Hz")
        self.stream.flush()

    def finish(self):
        self._render()
        self.stream.write("\n")
        self.stream.flush()
