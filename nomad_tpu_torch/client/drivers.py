"""Task drivers.

Reference semantics: plugins/drivers/driver.go DriverPlugin (StartTask/
WaitTask/StopTask/DestroyTask/InspectTask); drivers/mock/driver.go
(configurable fake: run_for, exit_code, start_error, kill_after —
:113-226) and drivers/rawexec (fork/exec runner).

In-process classes for now; the plugin process boundary (go-plugin gRPC
in the reference) arrives with the gRPC layer.
"""

from __future__ import annotations

import os as _os
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..plugins.hclspec import Attr as _SpecAttr


@dataclass
class TaskHandle:
    task_name: str
    driver: str
    config: dict
    proc: Optional[object] = None
    exit_code: Optional[int] = None
    error: str = ""
    started_at: float = 0.0
    finished_at: float = 0.0
    id: str = ""
    _done: threading.Event = field(default_factory=threading.Event)
    _kill: threading.Event = field(default_factory=threading.Event)

    def __post_init__(self):
        if not self.id:
            from ..utils.ids import generate_uuid
            self.id = generate_uuid()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def done(self) -> bool:
        return self._done.is_set()

    def recoverable_state(self) -> dict:
        """What the client state DB persists so a restarted client can
        re-attach (plugins/drivers TaskHandle / RecoverTask)."""
        pid = None
        if self.proc is not None:
            pid = getattr(self.proc, "pid", None)
        out = {"id": self.id, "task_name": self.task_name,
               "driver": self.driver, "config": dict(self.config),
               "pid": pid, "started_at": self.started_at}
        cg = getattr(self, "cgroup_name", None)
        if cg:
            out["cgroup"] = cg
        ea = getattr(self, "executor_addr", None)
        if ea:
            out["executor_addr"] = ea
            out["executor_pid"] = getattr(self, "executor_pid", None)
            out["executor_auth"] = getattr(self, "executor_auth", "")
        cid = getattr(self, "container_id", None)
        if cid:
            out["container_id"] = cid
            dp = getattr(self, "docklog_pid", None)
            if dp:
                out["docklog_pid"] = dp
                out["log_dir"] = getattr(self, "log_dir", "")
                out["log_max_files"] = getattr(self, "log_max_files", 10)
                out["log_max_file_size_mb"] = getattr(
                    self, "log_max_file_size_mb", 10)
        mon = getattr(self, "monitor_path", None)
        if mon:
            out["monitor_path"] = mon
        return out


def resolve_host_ports(alloc_networks) -> Dict[str, tuple]:
    """label -> (host_port, host_ip) from the alloc's allocated
    networks, which arrive as model objects (in-proc drivers) or wire
    dicts (across the plugin boundary). Shared by the docker and qemu
    port_map paths."""
    def field(obj, name, default=None):
        if isinstance(obj, dict):
            return obj.get(name, default)
        return getattr(obj, name, default)

    host_ports: Dict[str, tuple] = {}
    for nw in alloc_networks or []:
        for p in list(field(nw, "reserved_ports") or []) + \
                list(field(nw, "dynamic_ports") or []):
            host_ports[field(p, "label")] = (
                field(p, "value"), field(nw, "ip", "") or "0.0.0.0")
    return host_ports


def child_process_env(extra: Optional[Dict[str, str]] = None
                      ) -> Dict[str, str]:
    """Minimal env for spawned helper processes (executor, docklog,
    plugin launchers): the repo on PYTHONPATH plus a sane PATH —
    deliberately NOT the agent's env (credentials must not leak into
    task-side processes)."""
    repo_root = _os.path.dirname(_os.path.dirname(
        _os.path.dirname(_os.path.abspath(__file__))))
    env = {"PYTHONPATH": repo_root,
           "PATH": _os.environ.get("PATH", "/usr/bin:/bin")}
    if extra:
        env.update(extra)
    return env


def _parse_duration(val) -> float:
    """'500ms' / '3s' / '2m' / numeric seconds."""
    if isinstance(val, (int, float)):
        return float(val)
    s = str(val).strip()
    for suffix, mult in (("ms", 0.001), ("s", 1.0), ("m", 60.0), ("h", 3600.0)):
        if s.endswith(suffix):
            try:
                return float(s[: -len(suffix)]) * mult
            except ValueError:
                return 0.0
    try:
        return float(s)
    except ValueError:
        return 0.0


class MockDriver:
    """drivers/mock: runs for config['run_for'], exits config['exit_code'];
    config['start_error'] fails the start."""

    name = "mock_driver"
    # typed config schema (plugins/shared/hclspec; drivers/mock
    # driver.go:113-226 declares the same knobs via hclspec)
    CONFIG_SPEC = {
        "run_for": _SpecAttr("string", default="0s"),
        "exit_code": _SpecAttr("number", default=0),
        "start_error": _SpecAttr("string"),
        "recover_error": _SpecAttr("string"),
        "stdout_string": _SpecAttr("string"),
    }

    def fingerprint(self) -> Dict[str, str]:
        return {"driver.mock_driver": "1"}

    def start_task(self, task_name: str, config: dict, env: dict,
                   ctx: Optional[dict] = None) -> TaskHandle:
        if config.get("start_error"):
            raise RuntimeError(str(config["start_error"]))
        h = TaskHandle(task_name=task_name, driver=self.name, config=config,
                       started_at=time.time())
        run_for = _parse_duration(config.get("run_for", 0))
        exit_code = int(config.get("exit_code", 0))

        def run():
            if run_for > 0:
                h._kill.wait(run_for)
            h.exit_code = 137 if h._kill.is_set() else exit_code
            h.finished_at = time.time()
            h._done.set()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return h

    def stop_task(self, handle: TaskHandle, timeout_s: float = 5.0) -> None:
        handle._kill.set()
        handle.wait(timeout_s)

    def recover_task(self, state: dict) -> Optional[TaskHandle]:
        """Re-attach to a 'live' mock task (drivers/mock recovery
        simulation knobs, driver.go:169-264): fails when the persisted
        config asks for it; otherwise reconstructs a handle whose
        remaining runtime is derived from the persisted start time, so
        a task that should still be running keeps 'running' and one
        past its run_for completes immediately."""
        config = state.get("config", {})
        if config.get("recover_error"):
            return None
        run_for = _parse_duration(config.get("run_for", 0))
        exit_code = int(config.get("exit_code", 0))
        started_at = float(state.get("started_at") or time.time())
        h = TaskHandle(task_name=state["task_name"], driver=self.name,
                       config=config, started_at=started_at,
                       id=state.get("id", ""))
        remaining = started_at + run_for - time.time()

        def run():
            if remaining > 0:
                h._kill.wait(remaining)
            h.exit_code = 137 if h._kill.is_set() else exit_code
            h.finished_at = time.time()
            h._done.set()

        threading.Thread(target=run, daemon=True).start()
        return h


class RawExecDriver:
    """drivers/rawexec: plain fork/exec, no isolation."""

    name = "raw_exec"
    CONFIG_SPEC = {
        "command": _SpecAttr("string", required=True),
        "args": _SpecAttr("list(string)", default=[]),
    }

    def fingerprint(self) -> Dict[str, str]:
        return {"driver.raw_exec": "1"}

    def start_task(self, task_name: str, config: dict, env: dict,
                   ctx: Optional[dict] = None) -> TaskHandle:
        command = config.get("command")
        if not command:
            raise RuntimeError("missing command")
        args = [command] + list(config.get("args", []))
        ctx = ctx or {}
        cwd = ctx.get("task_dir") or None
        # logmon: pump stdout/stderr into size-rotated files under the
        # alloc's log dir (client/logmon); without a log dir, discard
        log_dir = ctx.get("log_dir")
        stdout = stderr = subprocess.DEVNULL
        if log_dir:
            stdout = stderr = subprocess.PIPE
        try:
            proc = subprocess.Popen(
                args, env={**env} if env else None, cwd=cwd,
                stdout=stdout, stderr=stderr)
        except OSError as e:
            raise RuntimeError(f"failed to exec {command}: {e}")
        h = TaskHandle(task_name=task_name, driver=self.name, config=config,
                       proc=proc, started_at=time.time())
        if log_dir:
            from .logmon import RotatingWriter, pump
            max_files = int(ctx.get("log_max_files", 10))
            max_mb = int(ctx.get("log_max_file_size_mb", 10))
            pump(proc.stdout, RotatingWriter(
                log_dir, f"{task_name}.stdout", max_files, max_mb))
            pump(proc.stderr, RotatingWriter(
                log_dir, f"{task_name}.stderr", max_files, max_mb))

        def wait():
            code = proc.wait()
            h.exit_code = code
            h.finished_at = time.time()
            h._done.set()

        threading.Thread(target=wait, daemon=True).start()
        return h

    def stop_task(self, handle: TaskHandle, timeout_s: float = 5.0) -> None:
        proc = handle.proc
        if proc is None:
            pid = getattr(handle, "_recovered_pid", None)
            if pid:
                import os
                import signal as _signal
                try:
                    os.kill(pid, _signal.SIGTERM)
                except ProcessLookupError:
                    pass
            handle._kill.set()
            handle.wait(timeout_s)
            return
        proc.terminate()
        try:
            proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
        handle.wait(1.0)

    def recover_task(self, state: dict) -> Optional[TaskHandle]:
        """Re-attach to a running process by pid (the executor
        re-attach path, task_runner.go:996). A non-child pid can't be
        wait()ed, so liveness is polled."""
        import os
        pid = state.get("pid")
        if not pid:
            return None
        try:
            os.kill(pid, 0)
        except (ProcessLookupError, PermissionError):
            return None
        h = TaskHandle(task_name=state["task_name"], driver=self.name,
                       config=state.get("config", {}),
                       started_at=float(state.get("started_at") or 0),
                       id=state.get("id", ""))
        h._recovered_pid = pid

        def poll():
            while not h._kill.is_set():
                try:
                    os.kill(pid, 0)
                except (ProcessLookupError, PermissionError):
                    break
                time.sleep(0.1)
            # exit status of a non-child is unknowable; treat
            # disappeared-without-kill as clean exit
            h.exit_code = 137 if h._kill.is_set() else 0
            h.finished_at = time.time()
            h._done.set()

        threading.Thread(target=poll, daemon=True).start()
        return h

    def stats(self, handle: TaskHandle) -> Dict[str, float]:
        """Resource usage from /proc/<pid> (the unprivileged analog of
        executor Stats(): raw_exec has no cgroup, so RSS comes from
        statm and cpu from utime+stime). Feeds the client host-stats
        sampler's per-alloc ResourceUsage."""
        proc = handle.proc
        pid = proc.pid if proc is not None \
            else getattr(handle, "_recovered_pid", None)
        if not pid or handle.done():
            return {}
        import os
        try:
            with open(f"/proc/{pid}/statm") as f:
                rss_pages = int(f.read().split()[1])
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            # fields after comm: index 11/12 are utime/stime in ticks
            ticks = float(fields[11]) + float(fields[12])
        except (OSError, IndexError, ValueError):
            return {}
        hz = os.sysconf("SC_CLK_TCK") or 100
        page = os.sysconf("SC_PAGE_SIZE") or 4096
        return {"memory_bytes": float(rss_pages * page),
                "cpu_total_ns": ticks / hz * 1e9}


class ExecDriver(RawExecDriver):
    """drivers/exec: fork/exec with cgroup resource limits and a
    mount-namespace chroot when the host allows it (root + writable
    cgroupfs), per drivers/shared/executor/executor_linux.go. Falls
    back to raw fork/exec otherwise, and advertises which mode the
    fingerprint detected (driver.exec.isolation)."""

    CONFIG_SPEC = {
        "command": _SpecAttr("string", required=True),
        "args": _SpecAttr("list(string)", default=[]),
        "user": _SpecAttr("string"),
        "no_chroot": _SpecAttr("bool", default=False),
        "no_isolation": _SpecAttr("bool", default=False),
    }

    name = "exec"

    def fingerprint(self) -> Dict[str, str]:
        from .executor import IsolatedExecutor
        isolated = IsolatedExecutor.available()
        return {"driver.exec": "1",
                "driver.exec.isolation": "cgroups" if isolated else "none"}

    @staticmethod
    def _spawn_executor():
        """Launch the supervising executor process (executor_plugin.go
        analog) in its own session and dial its RPC handshake. A
        per-executor auth token (handed over via the root-only child
        env) gates every RPC — the listener is a localhost socket and
        Exec/State expose the task's env and isolation."""
        import secrets as _secrets
        import sys as _sys

        from ..plugins.base import (HANDSHAKE_COOKIE_KEY,
                                    HANDSHAKE_COOKIE_VALUE,
                                    HANDSHAKE_PREFIX)
        from ..rpc.client import RpcClient
        token = _secrets.token_hex(16)
        env = child_process_env({
            HANDSHAKE_COOKIE_KEY: HANDSHAKE_COOKIE_VALUE,
            "NOMAD_TPU_TORCH_EXECUTOR_TOKEN": token})
        eproc = subprocess.Popen(
            [_sys.executable, "-m", "nomad_tpu_torch.client.executor_server"],
            env=env, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True,
            start_new_session=True)
        import select as _select
        ready, _w, _x = _select.select([eproc.stdout], [], [], 15.0)
        line = eproc.stdout.readline().strip() if ready else ""
        if not line.startswith(HANDSHAKE_PREFIX):
            eproc.kill()
            eproc.wait()
            raise RuntimeError(f"executor bad handshake: {line!r}")
        addr = line[len(HANDSHAKE_PREFIX):]
        return eproc, RpcClient(addr), addr, token

    @staticmethod
    def _ecall(h: TaskHandle, method: str, args: dict,
               timeout_s: float = 30.0):
        """Executor RPC with the handle's auth token injected."""
        return h.executor_rpc.call(
            method, {**args, "auth": getattr(h, "executor_auth", "")},
            timeout_s=timeout_s)

    def start_task(self, task_name: str, config: dict, env: dict,
                   ctx: Optional[dict] = None) -> TaskHandle:
        from .executor import IsolatedExecutor
        ctx = ctx or {}
        resources = ctx.get("resources") or {}
        if not IsolatedExecutor.available() or \
                config.get("no_isolation"):
            return super().start_task(task_name, config, env, ctx=ctx)

        command = config.get("command")
        if not command:
            raise RuntimeError("missing command")
        cwd = ctx.get("task_dir") or None
        cg_name = f"{ctx.get('alloc_id', 'anon')[:8]}-{task_name}"
        chroot_dir = None
        if cwd and not config.get("no_chroot"):
            chroot_dir = cwd
        # the jobspec `user` (Task.user / config user), defaulting to
        # an unprivileged account when the agent runs as root — an
        # isolated task must never silently inherit root
        # (drivers/shared/executor/executor.go user switch)
        run_as = config.get("user") or (ctx.get("user") or "") or "nobody"
        # spec is fully built BEFORE the executor spawns: an exception
        # here must not leak a detached executor process
        spec = {
            "cgroup": cg_name,
            "cpu_shares": int(resources.get("cpu", 0)),
            "memory_mb": int(resources.get("memory_mb", 0)),
            "chroot_dir": chroot_dir,
            "command": command,
            "args": list(config.get("args", [])),
            "env": {**env} if env else {},
            "cwd": cwd,
            "user": run_as,
            "chown_dirs": [cwd] if cwd else [],
            "bind_mounts": list(ctx.get("volume_mounts") or []),
            "log_dir": ctx.get("log_dir"),
            "task_name": task_name,
            "log_max_files": int(ctx.get("log_max_files", 10)),
            "log_max_file_size_mb": int(
                ctx.get("log_max_file_size_mb", 10)),
        }
        # the OUT-OF-PROC executor owns cgroup + containment + logs
        # (drivers/shared/executor/executor_plugin.go): the client
        # holds only an RPC handle, so supervision and log rotation
        # survive a client restart, and `alloc exec` can enter the
        # task's isolation through Executor.Exec
        try:
            eproc, rpc, addr, token = self._spawn_executor()
        except (OSError, subprocess.SubprocessError, RuntimeError) as e:
            raise RuntimeError(f"failed to start executor: {e}")
        try:
            res = rpc.call("Executor.Launch",
                           {"spec": spec, "auth": token},
                           timeout_s=30.0)
        except Exception as e:
            try:
                eproc.kill()
            except OSError:
                pass
            try:
                eproc.wait(timeout=5)
            except Exception:
                pass
            # the executor may have created the cgroup (and even the
            # task) before dying/timing out: reap it so the workload
            # can't keep running unsupervised while the scheduler
            # replaces it
            IsolatedExecutor.recover(cg_name).destroy()
            raise RuntimeError(f"failed to exec {command}: {e}")
        h = TaskHandle(task_name=task_name, driver=self.name,
                       config=config, proc=eproc,
                       started_at=res.get("started_at") or time.time())
        h.executor_rpc = rpc
        h.executor_addr = addr
        h.executor_auth = token
        h.executor_pid = eproc.pid
        h.task_pid = res.get("pid")
        h.cgroup_name = cg_name
        self._watch_executor(h)
        return h

    @classmethod
    def _watch_executor(cls, h: TaskHandle) -> None:
        """Long-poll Executor.Wait until the task exits, then reflect
        the result on the handle (WaitTask over the process boundary)."""

        def wait():
            fails = 0
            while True:
                try:
                    res = cls._ecall(h, "Executor.Wait",
                                     {"timeout_s": 60.0},
                                     timeout_s=90.0)
                    fails = 0
                except Exception:
                    # transient RPC hiccups must not kill a live task:
                    # only give up once the executor PROCESS is gone or
                    # several consecutive calls failed (a dead executor
                    # means the task is unsupervised either way)
                    fails += 1
                    pid = getattr(h, "executor_pid", None)
                    alive = bool(pid) and \
                        _os.path.isdir(f"/proc/{pid}")
                    if alive and fails < 3:
                        time.sleep(1.0)
                        continue
                    h.error = h.error or "executor process lost"
                    h.exit_code = h.exit_code if h.exit_code is not None \
                        else -1
                    h.finished_at = time.time()
                    break
                if res.get("done"):
                    h.exit_code = res.get("exit_code")
                    if res.get("oom"):
                        h.error = "OOM Killed: memory limit exceeded"
                    h.finished_at = res.get("finished_at") or time.time()
                    try:
                        cls._ecall(h, "Executor.Quit", {},
                                   timeout_s=5.0)
                    except Exception:
                        pass
                    break
            # reap the executor child so it doesn't linger as a zombie
            # (recovered handles have no Popen to reap)
            p = h.proc
            if p is not None and hasattr(p, "wait"):
                try:
                    p.wait(timeout=15)
                except Exception:
                    pass
            h._done.set()

        threading.Thread(target=wait, daemon=True,
                         name=f"exec-wait-{h.id[:8]}").start()

    def stop_task(self, handle: TaskHandle, timeout_s: float = 5.0) -> None:
        rpc = getattr(handle, "executor_rpc", None)
        if rpc is None:
            super().stop_task(handle, timeout_s)
            executor = getattr(handle, "executor", None)
            if executor is not None:
                executor.destroy()
            return
        try:
            self._ecall(handle, "Executor.Shutdown",
                        {"grace_s": timeout_s},
                        timeout_s=timeout_s + 30.0)
            self._ecall(handle, "Executor.Quit", {}, timeout_s=5.0)
        except Exception:
            # executor unresponsive: kill it and reap the cgroup (which
            # terminates member processes)
            pid = getattr(handle, "executor_pid", None)
            if pid:
                try:
                    _os.kill(pid, 9)
                except OSError:
                    pass
                p = handle.proc
                if p is not None and hasattr(p, "wait"):
                    try:
                        p.wait(timeout=5)
                    except Exception:
                        pass
            cg = getattr(handle, "cgroup_name", None)
            if cg:
                from .executor import IsolatedExecutor
                IsolatedExecutor.recover(cg).destroy()
            handle.exit_code = handle.exit_code \
                if handle.exit_code is not None else -1
            handle.finished_at = handle.finished_at or time.time()
            handle._done.set()

    def exec_in_task(self, handle: TaskHandle, argv, timeout_s: float
                     = 30.0) -> Dict:
        """Run a command inside the task's isolation (same cgroup +
        chroot) through the executor — the `alloc exec` entry
        (executor_linux.go Exec). Returns {exit_code, output,
        timed_out}."""
        rpc = getattr(handle, "executor_rpc", None)
        if rpc is None:
            raise RuntimeError("task has no out-of-proc executor")
        return self._ecall(handle, "Executor.Exec",
                           {"cmd": list(argv), "timeout_s": timeout_s},
                           timeout_s=timeout_s + 30.0)

    def recover_task(self, state: dict) -> Optional[TaskHandle]:
        """Re-dial the still-running executor process (RecoverTask over
        the executor boundary, executor_plugin.go): supervision, logs,
        and exec keep working after a client restart. Falls back to
        pid adoption + cgroup reap for pre-executor states or a dead
        executor."""
        addr = state.get("executor_addr")
        if addr:
            from ..rpc.client import RpcClient
            rpc = None
            auth = state.get("executor_auth", "")
            try:
                rpc = RpcClient(addr)
                st = rpc.call("Executor.State", {"auth": auth},
                              timeout_s=5.0)
            except Exception:
                if rpc is not None:
                    rpc.close()
                rpc = None
            if rpc is not None:
                h = TaskHandle(task_name=state.get("task_name", ""),
                               driver=self.name,
                               config=state.get("config") or {},
                               proc=None,
                               started_at=st.get("started_at") or
                               state.get("started_at") or 0.0,
                               id=state.get("id") or "")
                h.executor_rpc = rpc
                h.executor_addr = addr
                h.executor_auth = auth
                h.executor_pid = state.get("executor_pid")
                h.task_pid = st.get("pid")
                h.cgroup_name = state.get("cgroup", "")
                if st.get("done"):
                    h.exit_code = st.get("exit_code")
                    if st.get("oom"):
                        h.error = "OOM Killed: memory limit exceeded"
                    h.finished_at = st.get("finished_at") or time.time()
                    h._done.set()
                    try:
                        self._ecall(h, "Executor.Quit", {},
                                    timeout_s=5.0)
                    except Exception:
                        pass
                else:
                    self._watch_executor(h)
                return h
            # executor gone: the task group lives only in the cgroup —
            # reap it so a fresh start doesn't double-run
            cg = state.get("cgroup")
            if cg:
                from .executor import IsolatedExecutor
                IsolatedExecutor.recover(cg).destroy()
            return None
        h = super().recover_task(state)
        cg = state.get("cgroup")
        if cg:
            from .executor import IsolatedExecutor
            executor = IsolatedExecutor.recover(cg)
            if h is None:
                # process already gone: reap the leftover cgroup now
                executor.destroy()
            else:
                h.executor = executor
                h.cgroup_name = cg

                def cleanup():
                    h.wait()
                    executor.destroy()

                threading.Thread(target=cleanup, daemon=True).start()
        return h

    def stats(self, handle: TaskHandle) -> Dict[str, float]:
        """Resource usage for a running task (executor Stats() ->
        client task gauges)."""
        rpc = getattr(handle, "executor_rpc", None)
        if rpc is not None:
            try:
                return self._ecall(handle, "Executor.Stats", {},
                                   timeout_s=10.0).get("stats", {})
            except Exception:
                return {}
        executor = getattr(handle, "executor", None)
        if executor is None:
            return {}
        return executor.stats()


class JavaDriver(RawExecDriver):
    """drivers/java/driver.go: run a jar or class on the host JVM.
    Conditional on a working `java` binary (the availability probe
    drops the driver cleanly on hosts without one, like docker)."""

    name = "java"
    CONFIG_SPEC = {
        "jar_path": _SpecAttr("string"),
        "class": _SpecAttr("string"),
        "class_path": _SpecAttr("string"),
        "args": _SpecAttr("list(string)", default=[]),
        "jvm_options": _SpecAttr("list(string)", default=[]),
    }

    def available(self) -> bool:
        import shutil
        return shutil.which("java") is not None

    def fingerprint(self) -> Dict[str, str]:
        """javaVersionInfo (driver.go:239): `java -version` writes to
        STDERR; parse version/runtime/vm lines."""
        try:
            out = subprocess.run(["java", "-version"],
                                 capture_output=True, text=True,
                                 timeout=10)
        except (OSError, subprocess.TimeoutExpired):
            return {}
        text = out.stderr or out.stdout or ""
        attrs = {"driver.java": "1"}
        import re as _re
        m = _re.search(r'version "([^"]+)"', text)
        if m:
            attrs["driver.java.version"] = m.group(1)
        # JAVA_TOOL_OPTIONS prepends "Picked up ..." lines to stderr;
        # skip them or runtime/vm land one line off
        lines = [line.strip() for line in text.splitlines()
                 if line.strip()
                 and not line.startswith("Picked up ")]
        if len(lines) > 1:
            attrs["driver.java.runtime"] = lines[1]
        if len(lines) > 2:
            attrs["driver.java.vm"] = lines[2]
        return attrs

    def start_task(self, task_name: str, config: dict, env: dict,
                   ctx: Optional[dict] = None) -> TaskHandle:
        """driver.go StartTask:311 — `jar_path or class must be
        specified`; argv = java [jvm_options] [-cp class_path]
        (-jar jar | class) [args]."""
        jar = config.get("jar_path") or ""
        cls = config.get("class") or ""
        if not jar and not cls:
            raise RuntimeError("jar_path or class must be specified")
        # absolute binary path (driver.go GetAbsolutePath): the task's
        # env map usually has no PATH, so exec must not depend on it
        import shutil
        java_bin = shutil.which("java") or "java"
        argv = [java_bin] + list(config.get("jvm_options") or [])
        if config.get("class_path"):
            argv += ["-cp", str(config["class_path"])]
        if jar:
            task_dir = (ctx or {}).get("task_dir") or ""
            if task_dir and not _os.path.isabs(jar):
                jar = _os.path.join(task_dir, jar)
            argv += ["-jar", jar]
        else:
            argv.append(cls)
        argv += [str(a) for a in config.get("args") or []]
        sub = dict(config)
        sub["command"], sub["args"] = argv[0], argv[1:]
        return super().start_task(task_name, sub, env, ctx=ctx)


class QemuDriver(RawExecDriver):
    """drivers/qemu/driver.go: boot a VM image under qemu-system.
    Conditional on the qemu binary; graceful shutdown rides a unix
    monitor socket (system_powerdown) with SIGTERM fallback."""

    name = "qemu"
    BINARY = "qemu-system-x86_64"
    CONFIG_SPEC = {
        "image_path": _SpecAttr("string", required=True),
        "accelerator": _SpecAttr("string", default="tcg"),
        "graceful_shutdown": _SpecAttr("bool", default=False),
        "args": _SpecAttr("list(string)", default=[]),
        "port_map": _SpecAttr("map(number)", default={}),
    }

    def available(self) -> bool:
        import shutil
        return shutil.which(self.BINARY) is not None

    def fingerprint(self) -> Dict[str, str]:
        try:
            out = subprocess.run([self.BINARY, "--version"],
                                 capture_output=True, text=True,
                                 timeout=10)
        except (OSError, subprocess.TimeoutExpired):
            return {}
        attrs = {"driver.qemu": "1"}
        import re as _re
        m = _re.search(r"version ([\d.]+)", out.stdout or "")
        if m:
            attrs["driver.qemu.version"] = m.group(1)
        return attrs

    def start_task(self, task_name: str, config: dict, env: dict,
                   ctx: Optional[dict] = None) -> TaskHandle:
        """driver.go StartTask:402: -machine accel, -m from resources,
        -drive the image, -nographic; port_map becomes user-net
        hostfwd entries mapping scheduler-assigned host ports to guest
        ports."""
        ctx = ctx or {}
        image = str(config.get("image_path") or "")
        if not image:
            raise RuntimeError("image_path is required")
        task_dir = ctx.get("task_dir") or ""
        if task_dir and not _os.path.isabs(image):
            image = _os.path.join(task_dir, image)
        mem_mb = int((ctx.get("resources") or {}).get("memory_mb")
                     or 512)
        import shutil
        qemu_bin = shutil.which(self.BINARY) or self.BINARY
        argv = [qemu_bin,
                "-machine", "type=pc,accel="
                + str(config.get("accelerator") or "tcg"),
                "-name", f"nomad-{task_name}",
                "-m", f"{mem_mb}M",
                "-drive", f"file={image}",
                "-nographic"]
        monitor = ""
        if config.get("graceful_shutdown"):
            import tempfile
            from ..utils.ids import generate_uuid
            monitor = _os.path.join(
                task_dir or tempfile.gettempdir(),
                f"qmon-{generate_uuid()[:8]}.sock")
            # AF_UNIX sun_path limit — the reference rejects over-long
            # monitor paths up front (qemuLegacyMaxMonitorPathLen)
            # instead of letting qemu die with an opaque bind error
            if len(monitor.encode()) > 104:
                raise RuntimeError(
                    f"qemu monitor path {monitor!r} exceeds the unix "
                    "socket path limit; use a shorter alloc dir")
            argv += ["-monitor", f"unix:{monitor},server,nowait"]
        port_map = config.get("port_map") or {}
        if port_map:
            # hostfwd=tcp::<host>-:<guest> per mapped label
            # (driver.go:438-449); host ports come from the
            # scheduler's allocated networks
            host_ports = resolve_host_ports(ctx.get("alloc_networks"))
            fwds = []
            for label, guest in port_map.items():
                hp = host_ports.get(label)
                if not hp or not hp[0]:
                    raise RuntimeError(
                        f"unknown port label {label!r} in port_map")
                fwds.append(f"hostfwd=tcp::{int(hp[0])}-:{int(guest)}")
            argv += ["-netdev",
                     "user,id=user.0," + ",".join(fwds),
                     "-device", "virtio-net,netdev=user.0"]
        argv += [str(a) for a in config.get("args") or []]
        sub = dict(config)
        sub["command"], sub["args"] = argv[0], argv[1:]
        h = super().start_task(task_name, sub, env, ctx=ctx)
        h.monitor_path = monitor
        return h

    def stop_task(self, handle: TaskHandle, timeout_s: float = 5.0
                  ) -> None:
        """Graceful shutdown via the monitor socket
        (qemuGracefulShutdownMsg driver.go:41), then the SIGTERM/kill
        escalation."""
        monitor = getattr(handle, "monitor_path", "")
        if monitor:
            import socket
            try:
                with socket.socket(socket.AF_UNIX,
                                   socket.SOCK_STREAM) as sk:
                    sk.settimeout(2.0)
                    sk.connect(monitor)
                    sk.sendall(b"system_powerdown\n")
                # wait for a clean exit before escalating; works for
                # both child procs and restart-recovered handles
                # (whose liveness poller sets _done)
                if handle.proc is not None:
                    try:
                        handle.proc.wait(timeout_s)
                        handle.wait(1.0)
                        return
                    except subprocess.TimeoutExpired:
                        pass
                elif handle.wait(timeout_s):
                    return
            except OSError:
                pass
        super().stop_task(handle, timeout_s)

    def recover_task(self, state: dict) -> Optional[TaskHandle]:
        """Re-attach keeps the monitor socket path so graceful
        shutdown survives a client restart."""
        h = super().recover_task(state)
        if h is not None and state.get("monitor_path"):
            h.monitor_path = state["monitor_path"]
        return h


def _docker_driver():
    # deferred: docker_driver imports TaskHandle from this module
    from .docker_driver import DockerDriver
    return DockerDriver()


DRIVER_CATALOG = {
    "mock_driver": MockDriver,
    "raw_exec": RawExecDriver,
    "exec": ExecDriver,
    "docker": _docker_driver,
    "java": JavaDriver,
    "qemu": QemuDriver,
}
