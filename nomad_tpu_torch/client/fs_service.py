"""Alloc filesystem + exec service: the client-side implementation of
logs/fs/exec shared by the co-located HTTP fast path and the client's
RPC listener (servers forward remote requests here).

Reference surface: client/fs_endpoint.go (logs/ls/cat/stream),
client/lib/streamframer/framer.go (the frame shape: File/Offset/Data/
FileEvent, heartbeat when idle), client/alloc_endpoint.go:163
(Allocations.Exec). Transport differs by design: the reference speaks
framed streaming over yamux; here frames batch over poll-style RPC
round trips (offset-resumable, heartbeat frames when idle), which the
blocking-query RPC layer already models well.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils.ids import generate_uuid
from ..utils.locks import make_lock

MAX_FRAME_BYTES = 64 * 1024
MAX_FRAMES_PER_POLL = 16


class PathEscapeError(ValueError):
    pass


def _resolve(base: str, rel: str) -> str:
    target = os.path.realpath(os.path.join(base, rel.lstrip("/")))
    real_base = os.path.realpath(base)
    if target != real_base and not target.startswith(real_base + os.sep):
        raise PathEscapeError("path escapes the alloc dir")
    return target


def list_dir(base: str, rel: str) -> Optional[List[Dict]]:
    target = _resolve(base, rel)
    if not os.path.isdir(target):
        return None
    out = []
    for name in sorted(os.listdir(target)):
        p = os.path.join(target, name)
        is_file = os.path.isfile(p)
        entry = {"Name": name, "IsDir": os.path.isdir(p),
                 "Size": os.path.getsize(p) if is_file else 0}
        if is_file:
            # permission bits ride along so migrated executables keep
            # their +x (allocwatcher migrateRemoteAllocDir preserves
            # FileInfo modes)
            entry["FileMode"] = os.stat(p).st_mode & 0o7777
        out.append(entry)
    return out


def cat_file(base: str, rel: str) -> Optional[bytes]:
    target = _resolve(base, rel)
    if not os.path.isfile(target):
        return None
    with open(target, "rb") as f:
        return f.read()


def _log_files(base: str, task: str, stream: str) -> List[str]:
    log_dir = os.path.join(base, "alloc", "logs")
    try:
        names = sorted(
            (f for f in os.listdir(log_dir)
             if f.startswith(f"{task}.{stream}.")),
            key=lambda f: int(f.rsplit(".", 1)[1]))
    except (FileNotFoundError, ValueError):
        names = []
    return [os.path.join(log_dir, f) for f in names]


def read_logs(base: str, task: str, stream: str,
              offset: int) -> Tuple[bytes, int]:
    """(data from offset, total size) over the task's rotated log
    chain. Offset-aware: stats sizes, opens only tail files."""
    paths = _log_files(base, task, stream)
    sizes = [os.path.getsize(p) for p in paths]
    total = sum(sizes)
    chunks = []
    skip = offset
    for p, size in zip(paths, sizes):
        if skip >= size:
            skip -= size
            continue
        with open(p, "rb") as f:
            if skip:
                f.seek(skip)
                skip = 0
            chunks.append(f.read())
    return b"".join(chunks), total


def stream_frames(base: str, rel: Optional[str], offset: int,
                  task: str = "", log_type: str = "",
                  wait_s: float = 0.0) -> List[Dict]:
    """Framed read (streamframer shape): data frames carry
    File/Offset/Data; an idle source past `wait_s` yields ONE heartbeat
    frame (empty Data, current Offset) so pollers distinguish
    'no new bytes' from 'gone'. Callers resume from the last frame's
    Offset + len(Data)."""
    deadline = time.monotonic() + max(wait_s, 0.0)
    while True:
        if log_type:
            data, total = read_logs(base, task, log_type, offset)
            fname = f"{task}.{log_type}"
        else:
            target = _resolve(base, rel or "/")
            fname = rel or "/"
            if not os.path.isfile(target):
                return [{"File": fname, "Offset": offset, "Data": b"",
                         "FileEvent": "deleted"}]
            size = os.path.getsize(target)
            if offset > size:
                # rotation/truncation: restart from zero, tell the
                # consumer why (framer FileEvent "file truncated")
                return [{"File": fname, "Offset": 0, "Data": b"",
                         "FileEvent": "truncated"}]
            with open(target, "rb") as f:
                f.seek(offset)
                data = f.read()
            total = size
        if data:
            frames = []
            pos = offset
            for i in range(0, len(data), MAX_FRAME_BYTES):
                if len(frames) >= MAX_FRAMES_PER_POLL:
                    break
                chunk = data[i:i + MAX_FRAME_BYTES]
                frames.append({"File": fname, "Offset": pos,
                               "Data": chunk})
                pos += len(chunk)
            return frames
        if time.monotonic() >= deadline:
            return [{"File": fname, "Offset": total, "Data": b"",
                     "Heartbeat": True}]
        time.sleep(0.05)


class ExecSession:
    """One in-flight `alloc exec`: a command run inside the task's
    environment with piped stdin/stdout/stderr. Poll-based: io() feeds
    stdin and drains output frames until the process exits."""

    def __init__(self, argv: List[str], cwd: Optional[str],
                 env: Optional[Dict[str, str]]):
        self.id = generate_uuid()
        self._proc = subprocess.Popen(
            argv, cwd=cwd or None, env=env or None,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        self._out = b""
        self._err = b""
        self._l = make_lock()
        self._readers = [
            threading.Thread(target=self._pump, args=("_out",
                             self._proc.stdout), daemon=True),
            threading.Thread(target=self._pump, args=("_err",
                             self._proc.stderr), daemon=True)]
        for t in self._readers:
            t.start()

    def _pump(self, field: str, pipe) -> None:
        # read1: partial output must surface immediately — a buffered
        # read(4096) would hold an interactive session's output hostage
        # until 4KB accumulate or the process exits
        read1 = getattr(pipe, "read1", None)
        while True:
            chunk = read1(4096) if read1 is not None else pipe.read(4096)
            if not chunk:
                return
            with self._l:
                setattr(self, field, getattr(self, field) + chunk)

    def write_stdin(self, data: bytes, close: bool = False) -> None:
        if self._proc.stdin is not None:
            try:
                if data:
                    self._proc.stdin.write(data)
                    self._proc.stdin.flush()
                if close:
                    self._proc.stdin.close()
            except (BrokenPipeError, ValueError, OSError):
                pass

    def poll(self, wait_s: float = 0.0) -> Dict:
        deadline = time.monotonic() + max(wait_s, 0.0)
        while True:
            code = self._proc.poll()
            if code is not None:
                # drain completely before declaring exit: a fast
                # command can finish before the reader threads have
                # pulled its output off the pipes — the pipes hit EOF
                # now that the process is gone, so the joins are bounded
                for t in self._readers:
                    t.join(timeout=5.0)
            with self._l:
                out, self._out = self._out, b""
                err, self._err = self._err, b""
            if out or err or code is not None or \
                    time.monotonic() >= deadline:
                exited = code is not None and not out and not err
                return {"stdout": out, "stderr": err,
                        "exited": exited,
                        "exit_code": code if code is not None else -1}
            time.sleep(0.02)

    def signal(self, sig: int) -> None:
        try:
            self._proc.send_signal(sig)
        except (ProcessLookupError, OSError):
            pass

    def stop(self) -> None:
        try:
            self._proc.kill()
        except (ProcessLookupError, OSError):
            pass


class MockExecSession:
    """Exec against the mock driver: echoes stdin back on stdout (the
    fake the reference mock driver's Exec provides for tests)."""

    def __init__(self, argv: List[str]):
        self.id = generate_uuid()
        self._buf = b"" if not argv else (" ".join(argv) + "\n").encode()
        self._closed = False

    def write_stdin(self, data: bytes, close: bool = False) -> None:
        self._buf += data
        if close:
            self._closed = True

    def poll(self, wait_s: float = 0.0) -> Dict:
        out, self._buf = self._buf, b""
        exited = self._closed and not out
        return {"stdout": out, "stderr": b"", "exited": exited,
                "exit_code": 0 if exited else -1}

    def signal(self, sig: int) -> None:
        pass

    def stop(self) -> None:
        self._closed = True


class TaskExecSession:
    """`alloc exec` backed by the out-of-proc executor's Exec verb: the
    command runs INSIDE the task's isolation (same cgroup + chroot —
    executor_linux.go Exec). One-shot: output is delivered when the
    command completes; stdin is not streamed (the reference's non-tty
    exec shape)."""

    def __init__(self, driver, handle, argv: List[str],
                 env: Optional[Dict[str, str]] = None,
                 timeout_s: float = 300.0):
        import threading as _threading
        self.id = generate_uuid()
        self._out = b""
        self._exit: Optional[int] = None
        self._done = _threading.Event()
        self._l = make_lock()

        def run():
            try:
                res = driver.exec_in_task(handle, argv,
                                          timeout_s=timeout_s)
                with self._l:
                    self._out = bytes(res.get("output") or b"")
                    self._exit = int(res.get("exit_code", -1))
            except Exception as e:
                with self._l:
                    self._out = f"exec failed: {e}\n".encode()
                    self._exit = -1
            self._done.set()

        _threading.Thread(target=run, daemon=True,
                          name=f"task-exec-{self.id[:8]}").start()

    def write_stdin(self, data: bytes, close: bool = False) -> None:
        pass        # non-interactive

    def poll(self, wait_s: float = 0.0) -> Dict:
        self._done.wait(wait_s)
        with self._l:
            out, self._out = self._out, b""
            exited = self._done.is_set() and not out
            return {"stdout": out, "stderr": b"", "exited": exited,
                    "exit_code": self._exit if self._exit is not None
                    else -1}

    def signal(self, sig: int) -> None:
        pass

    def stop(self) -> None:
        self._done.set()


class ExecRegistry:
    """Session table for one client agent; sessions are garbage
    collected when stopped or after idle timeout."""

    IDLE_LIMIT_S = 300.0

    def __init__(self):
        self._l = make_lock()
        self._sessions: Dict[str, Tuple[object, float]] = {}

    def add(self, session) -> str:
        with self._l:
            self._gc()
            self._sessions[session.id] = (session, time.monotonic())
        return session.id

    def get(self, sid: str):
        with self._l:
            # gc here too: a node that never starts another exec must
            # still reap sessions whose caller vanished mid-stream
            self._gc()
            hit = self._sessions.get(sid)
            if hit is None:
                return None
            self._sessions[sid] = (hit[0], time.monotonic())
            return hit[0]

    def remove(self, sid: str) -> None:
        with self._l:
            hit = self._sessions.pop(sid, None)
        if hit is not None:
            hit[0].stop()

    def _gc(self) -> None:
        now = time.monotonic()
        for sid, (sess, seen) in list(self._sessions.items()):
            if now - seen > self.IDLE_LIMIT_S:
                sess.stop()
                del self._sessions[sid]
