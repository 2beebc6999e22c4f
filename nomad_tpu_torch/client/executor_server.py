"""The out-of-proc task executor: a supervising process between the
client agent and the task.

Reference: drivers/shared/executor/executor_plugin.go — the exec driver
launches `nomad executor` as a separate process speaking RPC
(Launch/Wait/Shutdown/Stats/Signal/Exec); the executor owns the task's
cgroup, containment, and log files, so the CLIENT can die and restart
while supervision continues, and RecoverTask re-dials the executor
instead of adopting a bare pid. Exec runs commands INSIDE the task's
isolation (same cgroup + chroot), which is what `alloc exec` needs
(executor_linux.go Exec).

Process shape: the driver spawns
    python -m nomad_tpu_torch.client.executor_server
with the plugin handshake cookie; the executor prints the handshake
line (protocol|addr) on stdout, detaches into its own session (so a
dying client doesn't take it down), and serves until Shutdown. Task
launch re-execs the exec_helper bootstrap exactly as the in-proc path
did — the containment recipe is shared, only its supervisor moved out
of the client.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional


class _ExecutorState:
    def __init__(self):
        self.proc: Optional[subprocess.Popen] = None
        self.spec: Dict = {}
        self.started_at = 0.0
        self.finished_at = 0.0
        self.exit_code: Optional[int] = None
        self.oom = False
        self.executor = None          # IsolatedExecutor (cgroup owner)
        self.done = threading.Event()
        self.log_threads: List[threading.Thread] = []


STATE = _ExecutorState()


def _spawn_helper(spec: Dict, stdout, stderr) -> subprocess.Popen:
    from .drivers import child_process_env
    helper_env = child_process_env()
    proc = subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch.client.exec_helper"],
        env=helper_env, stdin=subprocess.PIPE,
        stdout=stdout, stderr=stderr)
    proc.stdin.write(json.dumps(spec).encode())
    proc.stdin.close()
    # communicate() would flush the (closed) stdin and raise
    proc.stdin = None
    return proc


def _launch(args: Dict) -> Dict:
    """Executor.Launch: create the cgroup, start the contained task,
    own its logs (log rotation runs HERE so task output survives a
    client restart — the docklog stance)."""
    if STATE.proc is not None:
        raise RuntimeError("executor already launched a task")
    spec = dict(args["spec"])
    from .executor import IsolatedExecutor
    cg_name = spec.get("cgroup", "")
    isolated = bool(cg_name) and IsolatedExecutor.available()
    if isolated:
        STATE.executor = IsolatedExecutor(
            cg_name,
            cpu_shares=int(spec.get("cpu_shares", 0)),
            memory_mb=int(spec.get("memory_mb", 0)),
            chroot_dir=spec.get("chroot_dir"))
        spec["procs_files"] = STATE.executor.procs_files
        spec["chroot_dirs"] = list(STATE.executor.chroot_dirs)
    else:
        spec.setdefault("procs_files", [])
        spec["chroot_dir"] = None

    log_dir = spec.pop("log_dir", None)
    task_name = spec.pop("task_name", "task")
    stdout = stderr = subprocess.DEVNULL
    if log_dir:
        stdout = stderr = subprocess.PIPE
    STATE.spec = spec
    STATE.proc = _spawn_helper(spec, stdout, stderr)
    STATE.started_at = time.time()
    if log_dir:
        from .logmon import RotatingWriter, pump
        max_files = int(spec.pop("log_max_files", 10))
        max_mb = int(spec.pop("log_max_file_size_mb", 10))
        pump(STATE.proc.stdout, RotatingWriter(
            log_dir, f"{task_name}.stdout", max_files, max_mb))
        pump(STATE.proc.stderr, RotatingWriter(
            log_dir, f"{task_name}.stderr", max_files, max_mb))

    def waiter():
        code = STATE.proc.wait()
        STATE.exit_code = code
        if code in (-9, 137) and STATE.executor is not None \
                and STATE.executor.oom_killed():
            STATE.oom = True
            STATE.exit_code = 137
        STATE.finished_at = time.time()
        if STATE.executor is not None:
            STATE.executor.destroy()
        STATE.done.set()

    threading.Thread(target=waiter, daemon=True).start()
    return {"pid": STATE.proc.pid, "started_at": STATE.started_at,
            "isolated": isolated}


def _wait(args: Dict) -> Dict:
    timeout = args.get("timeout_s")
    done = STATE.done.wait(float(timeout) if timeout else None)
    return {"done": bool(done), "exit_code": STATE.exit_code,
            "finished_at": STATE.finished_at,
            "oom": STATE.oom}


def _shutdown_task(args: Dict) -> Dict:
    import signal as _signal
    grace = float(args.get("grace_s", 5.0))
    proc = STATE.proc
    if proc is not None and proc.poll() is None:
        try:
            # the helper setsid()s, so signal the whole task group
            os.killpg(proc.pid, _signal.SIGTERM)
        except (ProcessLookupError, PermissionError, OSError):
            proc.terminate()
        if not STATE.done.wait(grace):
            try:
                os.killpg(proc.pid, _signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                proc.kill()
            STATE.done.wait(5.0)
    return {"exit_code": STATE.exit_code}


def _signal_task(args: Dict) -> Dict:
    sig = int(args.get("signal", 15))
    proc = STATE.proc
    if proc is not None and proc.poll() is None:
        try:
            os.killpg(proc.pid, sig)
        except (ProcessLookupError, PermissionError, OSError):
            proc.send_signal(sig)
    return {}


def _stats(_args: Dict) -> Dict:
    if STATE.executor is not None:
        return {"stats": STATE.executor.stats()}
    return {"stats": {}}


def _exec_in_task(args: Dict) -> Dict:
    """Executor.Exec: run a command INSIDE the task's isolation — same
    cgroup, same chroot view — and return its output
    (executor_linux.go Exec; the alloc-exec-into-isolation path)."""
    argv = list(args.get("cmd") or [])
    if not argv:
        raise ValueError("exec requires a command")
    timeout = float(args.get("timeout_s", 30.0))
    spec = {
        "procs_files": list(STATE.spec.get("procs_files", [])),
        "chroot_dir": STATE.spec.get("chroot_dir"),
        "chroot_dirs": list(STATE.spec.get("chroot_dirs", [])),
        # the exec session must see the task's volumes at their
        # destinations, not empty stub dirs
        "bind_mounts": list(STATE.spec.get("bind_mounts", [])),
        "command": argv[0],
        "args": argv[1:],
        "env": dict(args.get("env") or STATE.spec.get("env") or {}),
        "cwd": args.get("cwd") or STATE.spec.get("cwd"),
        "user": STATE.spec.get("user"),
    }
    proc = _spawn_helper(spec, subprocess.PIPE, subprocess.STDOUT)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        return {"exit_code": -1, "output": out or b"",
                "timed_out": True}
    return {"exit_code": proc.returncode, "output": out or b"",
            "timed_out": False}


def _state(_args: Dict) -> Dict:
    return {"pid": STATE.proc.pid if STATE.proc else None,
            "started_at": STATE.started_at,
            "finished_at": STATE.finished_at,
            "done": STATE.done.is_set(),
            "exit_code": STATE.exit_code,
            "oom": STATE.oom,
            "cgroup": getattr(STATE.executor, "name", "")}


def main() -> int:
    from ..plugins.base import (HANDSHAKE_COOKIE_KEY,
                                HANDSHAKE_COOKIE_VALUE, HANDSHAKE_PREFIX)
    if os.environ.get(HANDSHAKE_COOKIE_KEY) != HANDSHAKE_COOKIE_VALUE:
        print("This binary is the task executor and must be launched "
              "by the nomad-tpu client agent", file=sys.stderr)
        return 1
    # detach from the client's session: a dying client must not take
    # the executor (and its task) down with it
    try:
        os.setsid()
    except OSError:
        pass
    from ..rpc.server import RpcServer
    stop = threading.Event()

    def _quit(_args: Dict) -> Dict:
        stop.set()
        return {}

    # every call must carry the per-executor auth token the spawning
    # driver generated (passed via our env — only root can read it):
    # the listener is a localhost TCP socket, and without auth any
    # local user could call Executor.Exec into the task or read its
    # env (VAULT_TOKEN) back out. The stdin-only spec transport this
    # replaced existed exactly to avoid that exposure.
    token = os.environ.get("NOMAD_TPU_TORCH_EXECUTOR_TOKEN", "")

    def _authed(fn):
        def wrapper(args: Dict) -> Dict:
            import hmac
            supplied = str(args.get("auth", ""))
            if not token or not hmac.compare_digest(supplied, token):
                raise PermissionError("executor auth token mismatch")
            return fn(args)
        return wrapper

    rpc = RpcServer(methods={
        name: _authed(fn) for name, fn in {
            "Executor.Launch": _launch,
            "Executor.Wait": _wait,
            "Executor.Shutdown": _shutdown_task,
            "Executor.Signal": _signal_task,
            "Executor.Stats": _stats,
            "Executor.Exec": _exec_in_task,
            "Executor.State": _state,
            "Executor.Quit": _quit,
        }.items()})
    rpc.start()
    sys.stdout.write(HANDSHAKE_PREFIX + rpc.addr + "\n")
    sys.stdout.flush()
    # serve until told to quit; unlike driver plugins the executor must
    # NOT exit when the client's stdin pipe closes — surviving the
    # client is the whole point. It exits when its task is done AND the
    # client has collected the result (Quit), or after an orphan grace
    # period once the task finished.
    while not stop.is_set():
        if STATE.done.is_set():
            # task finished: linger briefly for a reconnecting client
            # to collect the result, then exit
            if stop.wait(60.0):
                break
            break
        stop.wait(1.0)
    rpc.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
