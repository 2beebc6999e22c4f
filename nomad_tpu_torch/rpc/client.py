"""Client-side RPC connection with seq demultiplexing and reconnect.

One TCP connection carries concurrent in-flight calls: a reader thread
matches response frames to waiting callers by seq (the role yamux +
net/rpc's pending map plays in the reference, helper/pool/pool.go).
On connection failure every pending call errors out and the next call
redials — the caller (the client agent's retry loops) owns backoff.
"""

from __future__ import annotations

import itertools
import socket
import threading
from typing import Any, Dict, Optional

from .codec import FrameCodec, RpcError
from ..utils.locks import make_lock


class _Pending:
    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[str] = None


class RpcClient:
    def __init__(self, addr: str, dial_timeout_s: float = 5.0):
        host, _, port = addr.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.dial_timeout_s = dial_timeout_s
        self._seq = itertools.count(1)
        self._lock = make_lock()          # connection + write lock
        self._codec: Optional[FrameCodec] = None
        self._pending: Dict[int, _Pending] = {}
        self._closed = False

    # -- connection management ----------------------------------------
    def _ensure_conn(self) -> FrameCodec:
        with self._lock:
            if self._codec is not None:
                return self._codec
            if self._closed:
                raise RpcError("client closed")
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.dial_timeout_s)
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._codec = FrameCodec(sock)
            t = threading.Thread(target=self._read_loop, daemon=True,
                                 args=(self._codec,), name="rpc-reader")
            t.start()
            return self._codec

    def _read_loop(self, codec: FrameCodec) -> None:
        try:
            while True:
                frame = codec.read_frame()
                if frame is None:
                    break
                seq, err, result = frame
                p = self._pending.pop(seq, None)
                if p is not None:
                    p.error = err
                    p.result = result
                    p.event.set()
        except (ConnectionError, OSError, RpcError):
            pass
        # connection died: fail everything in flight
        with self._lock:
            if self._codec is codec:
                self._codec = None
        for seq in list(self._pending):
            p = self._pending.pop(seq, None)
            if p is not None:
                p.error = "connection lost"
                p.event.set()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._codec is not None:
                try:
                    self._codec.sock.close()
                except OSError:
                    pass
                self._codec = None

    # -- calls ---------------------------------------------------------
    def call(self, method: str, args: Optional[Dict] = None,
             timeout_s: float = 60.0) -> Any:
        codec = self._ensure_conn()
        seq = next(self._seq)
        p = _Pending()
        self._pending[seq] = p
        try:
            with self._lock:
                codec.write_frame([seq, method, args or {}])
        except (ConnectionError, OSError) as e:
            self._pending.pop(seq, None)
            with self._lock:
                if self._codec is codec:
                    self._codec = None
            raise RpcError(f"send failed: {e}") from e
        if not p.event.wait(timeout_s):
            self._pending.pop(seq, None)
            raise RpcError(f"rpc {method} timed out after {timeout_s}s")
        if p.error is not None:
            raise RpcError(p.error)
        return p.result
