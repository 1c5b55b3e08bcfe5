"""Logging helpers: stdout tee (utils/io.py:4-15 parity); a copy of
``xmtpu/utils/logging.py``."""

from __future__ import annotations

import contextlib
import sys


class Tee:
    """Duplicate writes to several files (the reference's stdout capture)."""

    def __init__(self, *files):
        self.files = files

    def write(self, data):
        for f in self.files:
            f.write(data)
            f.flush()

    def flush(self):
        for f in self.files:
            f.flush()


@contextlib.contextmanager
def tee_stdout(path: str):
    """Capture stdout to ``path`` while still printing (driver usage pattern:
    ``sys.stdout = Tee(sys.stdout, open(log, 'w'))``)."""
    f = open(path, "w")
    old = sys.stdout
    sys.stdout = Tee(old, f)
    try:
        yield
    finally:
        sys.stdout = old
        f.close()
