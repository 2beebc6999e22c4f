"""Wire framing and codec.

Frame layout: 4-byte big-endian length prefix + payload. The payload is
a 3-element array:
    request:  [seq, method, args]
    response: [seq, error-or-None, result]
encoded with python-msgpack (the reference's go-msgpack codec,
nomad/rpc.go:27). Standard msgpack on both ends, so the port's frames
and the JAX package's interoperate. Model objects cross the wire as
plain dicts via utils/codec.to_wire/from_wire.
"""

from __future__ import annotations

import socket
import struct
from typing import Any, Optional

import msgpack

MAX_FRAME = 64 * 1024 * 1024


class RpcError(Exception):
    """Server-side error surfaced to the caller."""


class RpcRefused(RuntimeError):
    """Expected refusal a handler raises on purpose (e.g. a stopped
    raft node rejecting AppendEntries from a still-live leader during
    staggered shutdown, or a deposed leader refusing a forwarded
    write). The dispatcher surfaces it to the caller like any error
    but logs it at debug — it is a protocol outcome, not a server
    fault, and must not produce tracebacks on clean teardown or
    leadership movement. Subclasses RuntimeError so callers guarding
    raft writes with `except RuntimeError` treat a refusal exactly
    like the equivalent in-process raise."""


def dumps(obj: Any) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def loads(buf: bytes) -> Any:
    return msgpack.unpackb(buf, raw=False, strict_map_key=False)


class FrameCodec:
    """Reads/writes length-prefixed frames on a socket."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        # a bytearray grows in place: appending each chunk to a bytes
        # object would copy the whole frame read so far, O(n^2) in the
        # frame's size under the GIL (a snapshot frame is megabytes)
        self._rbuf = bytearray()

    def write_frame(self, payload: Any) -> None:
        buf = dumps(payload)
        self.sock.sendall(struct.pack(">I", len(buf)) + buf)

    def read_frame(self) -> Optional[Any]:
        """One frame, or None on clean EOF."""
        header = self._read_exact(4)
        if header is None:
            return None
        (length,) = struct.unpack(">I", header)
        if length > MAX_FRAME:
            raise RpcError(f"frame too large: {length}")
        body = self._read_exact(length)
        if body is None:
            return None
        return loads(body)

    def _read_exact(self, n: int) -> Optional[bytes]:
        buf = self._rbuf
        while len(buf) < n:
            chunk = self.sock.recv(min(max(n - len(buf), 65536), 1 << 22))
            if not chunk:
                return None
            buf += chunk
        out = bytes(buf[:n])
        del buf[:n]
        return out
