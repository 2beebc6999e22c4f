"""Task log collection with rotation (reference: client/logmon — a
per-task process pumping stdout/stderr FIFOs into size-rotated files
named <task>.<stream>.N; here a pump thread per stream does the same
in-process).
"""

from __future__ import annotations

import os
import threading
from typing import IO, Optional


class RotatingWriter:
    """Writes <prefix>.0, rotating to .1.. when max_file_size is hit and
    pruning past max_files (logmon/logging rotator.go)."""

    def __init__(self, directory: str, prefix: str,
                 max_files: int = 10, max_file_size_mb: int = 10):
        self.dir = directory
        self.prefix = prefix
        self.max_files = max(max_files, 1)
        self.max_bytes = max_file_size_mb * 1024 * 1024
        self._n = 0
        self._size = 0
        self._f: Optional[IO[bytes]] = None
        os.makedirs(directory, exist_ok=True)
        self._open()

    def _path(self, n: int) -> str:
        return os.path.join(self.dir, f"{self.prefix}.{n}")

    def _open(self) -> None:
        self._f = open(self._path(self._n), "ab")
        self._size = self._f.tell()

    def write(self, data: bytes) -> None:
        if self._f is None:
            return
        self._f.write(data)
        self._f.flush()
        self._size += len(data)
        if self._size >= self.max_bytes:
            self._f.close()
            self._n += 1
            self._open()
            drop = self._n - self.max_files
            if drop >= 0:
                try:
                    os.unlink(self._path(drop))
                except OSError:
                    pass

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def pump(stream, writer: RotatingWriter) -> threading.Thread:
    """Read a subprocess pipe into the rotating writer until EOF.
    Uses read1 so partial output lands in the log file as the task
    produces it — a buffered read(4096) would sit on a live pipe until
    4KB accumulate or the task exits, making `alloc logs -f` blind to
    everything a long-running task has printed so far."""
    read1 = getattr(stream, "read1", None)

    def run():
        try:
            while True:
                chunk = read1(4096) if read1 is not None \
                    else stream.read(4096)
                if not chunk:
                    break
                writer.write(chunk)
        except (OSError, ValueError):
            pass
        finally:
            writer.close()

    t = threading.Thread(target=run, daemon=True, name="logmon-pump")
    t.start()
    return t
