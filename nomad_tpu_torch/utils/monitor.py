"""Live log streaming support (reference: command/agent/monitor —
/v1/agent/monitor attaches a sink to the agent's logger and streams
records to the caller).
"""

from __future__ import annotations

import collections
import logging
import time
from typing import List, Optional, Tuple
from .locks import make_condition, make_lock

_LEVELS = {"trace": 5, "debug": logging.DEBUG, "info": logging.INFO,
           "warn": logging.WARNING, "error": logging.ERROR}


class MonitorBuffer(logging.Handler):
    """Ring buffer of formatted log records with blocking reads."""

    def __init__(self, capacity: int = 2048):
        super().__init__(level=logging.DEBUG)
        self.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._seq = 0
        self._cond = make_condition()

    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record)
        except Exception:       # pragma: no cover
            return
        with self._cond:
            self._seq += 1
            self._buf.append((self._seq, record.levelno, line))
            self._cond.notify_all()

    def read_since(self, seq: int, min_level: int,
                   timeout_s: float) -> Tuple[int, List[str]]:
        """Lines newer than seq at >= min_level; blocks up to timeout."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while True:
                out = [(s, line) for s, lvl, line in self._buf
                       if s > seq and lvl >= min_level]
                if out:
                    return out[-1][0], [line for _s, line in out]
                last = self._buf[-1][0] if self._buf else seq
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return max(seq, last), []
                self._cond.wait(remaining)


_buffer: Optional[MonitorBuffer] = None
_lock = make_lock()


def get_buffer() -> MonitorBuffer:
    """Attach (once) to the package logger tree and return the buffer."""
    global _buffer
    with _lock:
        if _buffer is None:
            _buffer = MonitorBuffer()
            logging.getLogger("nomad_tpu").addHandler(_buffer)
            logging.getLogger("nomad_tpu").setLevel(logging.DEBUG)
        return _buffer


def parse_level(name: str) -> int:
    return _LEVELS.get((name or "info").lower(), logging.INFO)
