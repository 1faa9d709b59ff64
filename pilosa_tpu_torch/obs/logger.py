"""Logger interface with verbose/debug split.

Reference: logger/logger.go (Logger interface: Printf/Debugf, NopLogger,
standard + verbose implementations).

The port's copy of pilosa_tpu/obs/logger.py.
"""

from __future__ import annotations

import sys
import time
from typing import Protocol


class Logger(Protocol):
    def printf(self, fmt: str, *args) -> None: ...
    def debugf(self, fmt: str, *args) -> None: ...


class NopLogger:
    def printf(self, fmt: str, *args) -> None:
        pass

    def debugf(self, fmt: str, *args) -> None:
        pass


class StandardLogger:
    def __init__(self, stream=None, verbose: bool = False):
        self.stream = stream or sys.stderr
        self.verbose = verbose

    def _emit(self, fmt: str, args) -> None:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S")
        self.stream.write(f"{ts} {fmt % args if args else fmt}\n")

    def printf(self, fmt: str, *args) -> None:
        self._emit(fmt, args)

    def debugf(self, fmt: str, *args) -> None:
        if self.verbose:
            self._emit(fmt, args)
