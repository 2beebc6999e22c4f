"""Isolated process executor: cgroup resource limits + mount-namespace
chroot containment for the `exec` driver.

Reference semantics: drivers/shared/executor/executor_linux.go (the
libcontainer-based executor: cgroup cpu/memory limits, chroot built
from a directory allowlist, namespace isolation, resource stats) and
executor_universal_linux.go. The TPU-native runtime keeps the same
contract with direct cgroupfs writes and CLONE_NEWNS bind mounts:

  - limits: memory.max / memory.limit_in_bytes (the kernel OOM-kills
    the task when exceeded — the "task exceeding memory_mb is killed"
    contract), cpu.weight / cpu.shares
  - containment: the child unshares its mount namespace, bind-mounts a
    read-only allowlist of system dirs into the task dir, and chroots;
    the mounts die with the namespace so nothing leaks host-side
  - stats: memory.current / memory.usage_in_bytes and cpu usage flow
    into the client's task gauges (executor Stats())

Everything degrades gracefully: without root or writable cgroupfs the
exec driver falls back to plain fork/exec (and says so in its
fingerprint), matching how the reference's exec driver refuses only
when isolation was explicitly required.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import signal
import time
from typing import Dict, List, Optional, Tuple
from ..utils.locks import make_lock

CG_ROOT = "/sys/fs/cgroup"
# apart from the JAX package's "nomad_tpu" parent, so the two never
# share a task cgroup or reap each other's
CG_PARENT = "nomad_tpu_torch"

# mount(2) / unshare(2) constants
MS_RDONLY = 1
MS_REMOUNT = 32
MS_BIND = 4096
MS_REC = 16384
MS_PRIVATE = 1 << 18
CLONE_NEWNS = 0x00020000

# chroot allowlist (drivers/shared/executor: chrootEnv defaults)
DEFAULT_CHROOT_DIRS = ("/bin", "/usr", "/lib", "/lib64", "/etc", "/sbin")

_libc = None


def _get_libc():
    global _libc
    if _libc is None:
        _libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                            use_errno=True)
    return _libc


class CgroupBackend:
    """v2 when /sys/fs/cgroup/cgroup.controllers lists controllers,
    else v1 (separate memory/ and cpu,cpuacct hierarchies)."""

    def __init__(self, root: str = CG_ROOT):
        self.root = root
        self.v2 = False
        ctrl = os.path.join(root, "cgroup.controllers")
        try:
            with open(ctrl) as f:
                self.v2 = bool(f.read().strip())
        except OSError:
            self.v2 = False

    # -- probes --------------------------------------------------------
    def writable(self) -> bool:
        try:
            if self.v2:
                probe = os.path.join(self.root, CG_PARENT)
                os.makedirs(probe, exist_ok=True)
                return True
            for sub in ("memory", "cpu"):
                probe = os.path.join(self.root, sub, CG_PARENT)
                os.makedirs(probe, exist_ok=True)
            return True
        except OSError:
            return False

    # -- lifecycle -----------------------------------------------------
    def _enable_v2_controllers(self) -> None:
        """Child cgroups only grow memory.max/cpu.weight files when the
        PARENT's cgroup.subtree_control delegates those controllers —
        enable them down the path root -> CG_PARENT."""
        for base in ("", CG_PARENT):
            ctl = os.path.join(self.root, base, "cgroup.subtree_control")
            for c in ("+memory", "+cpu"):
                _write(ctl, c, ignore_errors=True)

    def create(self, name: str, cpu_shares: int,
               memory_mb: int) -> List[str]:
        """Create the task's cgroup dirs, apply limits, and return the
        cgroup.procs paths the child must join. Cleans up the partial
        cgroup if a limit write fails."""
        try:
            return self._create(name, cpu_shares, memory_mb)
        except OSError:
            self.destroy(name)
            raise

    def _create(self, name: str, cpu_shares: int,
                memory_mb: int) -> List[str]:
        procs: List[str] = []
        if self.v2:
            self._enable_v2_controllers()
            path = os.path.join(self.root, CG_PARENT, name)
            os.makedirs(path, exist_ok=True)
            if memory_mb > 0:
                _write(os.path.join(path, "memory.max"),
                       str(memory_mb * 1024 * 1024))
                # fail fast instead of swapping forever
                _write(os.path.join(path, "memory.swap.max"), "0",
                       ignore_errors=True)
            if cpu_shares > 0:
                # shares (2..262144) -> weight (1..10000), the kernel's
                # own conversion formula
                weight = 1 + ((cpu_shares - 2) * 9999) // 262142
                _write(os.path.join(path, "cpu.weight"),
                       str(max(1, min(10000, weight))),
                       ignore_errors=True)
            procs.append(os.path.join(path, "cgroup.procs"))
            return procs
        mem = os.path.join(self.root, "memory", CG_PARENT, name)
        os.makedirs(mem, exist_ok=True)
        if memory_mb > 0:
            _write(os.path.join(mem, "memory.limit_in_bytes"),
                   str(memory_mb * 1024 * 1024))
            _write(os.path.join(mem, "memory.memsw.limit_in_bytes"),
                   str(memory_mb * 1024 * 1024), ignore_errors=True)
        procs.append(os.path.join(mem, "cgroup.procs"))
        cpu = os.path.join(self.root, "cpu", CG_PARENT, name)
        try:
            os.makedirs(cpu, exist_ok=True)
            if cpu_shares > 0:
                _write(os.path.join(cpu, "cpu.shares"),
                       str(max(2, cpu_shares)), ignore_errors=True)
            procs.append(os.path.join(cpu, "cgroup.procs"))
        except OSError:
            pass
        return procs

    def paths_for(self, name: str) -> List[str]:
        if self.v2:
            return [os.path.join(self.root, CG_PARENT, name)]
        return [os.path.join(self.root, "memory", CG_PARENT, name),
                os.path.join(self.root, "cpu", CG_PARENT, name)]

    def stats(self, name: str) -> Dict[str, float]:
        """Resource usage for the task's cgroup (executor Stats())."""
        out: Dict[str, float] = {}
        try:
            if self.v2:
                base = os.path.join(self.root, CG_PARENT, name)
                out["memory_bytes"] = float(_read(
                    os.path.join(base, "memory.current")) or 0)
                for line in (_read(os.path.join(base, "cpu.stat"))
                             or "").splitlines():
                    if line.startswith("usage_usec"):
                        out["cpu_total_ns"] = float(
                            line.split()[1]) * 1000.0
            else:
                mem = os.path.join(self.root, "memory", CG_PARENT, name)
                out["memory_bytes"] = float(_read(
                    os.path.join(mem, "memory.usage_in_bytes")) or 0)
                cpuacct = os.path.join(self.root, "cpuacct", CG_PARENT,
                                       name, "cpuacct.usage")
                usage = _read(cpuacct)
                if usage is None:
                    usage = _read(os.path.join(self.root, "cpu", CG_PARENT,
                                               name, "cpuacct.usage"))
                if usage is not None:
                    out["cpu_total_ns"] = float(usage)
        except (OSError, ValueError):
            pass
        return out

    def oom_killed(self, name: str) -> bool:
        """Did the kernel OOM-kill inside this cgroup?"""
        try:
            if self.v2:
                events = _read(os.path.join(self.root, CG_PARENT, name,
                                            "memory.events")) or ""
                for line in events.splitlines():
                    if line.startswith("oom_kill"):
                        return int(line.split()[1]) > 0
                return False
            ctl = _read(os.path.join(self.root, "memory", CG_PARENT, name,
                                     "memory.oom_control")) or ""
            for line in ctl.splitlines():
                if line.startswith("oom_kill "):
                    return int(line.split()[1]) > 0
            # older kernels only expose under_oom; fall back to failcnt
            fail = _read(os.path.join(self.root, "memory", CG_PARENT, name,
                                      "memory.failcnt"))
            return bool(fail and int(fail) > 0)
        except (OSError, ValueError):
            return False

    def destroy(self, name: str) -> None:
        """Kill any stragglers in the cgroup and remove it."""
        for base in self.paths_for(name):
            procs_file = os.path.join(base, "cgroup.procs")
            for _ in range(10):
                pids = (_read(procs_file) or "").split()
                if not pids:
                    break
                for pid in pids:
                    try:
                        os.kill(int(pid), signal.SIGKILL)
                    except (ProcessLookupError, ValueError,
                            PermissionError):
                        pass
                time.sleep(0.05)
            try:
                os.rmdir(base)
            except OSError:
                pass


def _write(path: str, value: str, ignore_errors: bool = False) -> None:
    try:
        with open(path, "w") as f:
            f.write(value)
    except OSError:
        if not ignore_errors:
            raise


def _read(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


class IsolatedExecutor:
    """Owns one task's cgroup (limits, stats, teardown) and the chroot
    parameters the exec_helper bootstrap applies in the re-exec'd
    child. Used by ExecDriver when available()."""

    _avail: Optional[bool] = None
    _avail_lock = make_lock()

    @classmethod
    def available(cls) -> bool:
        with cls._avail_lock:
            if cls._avail is None:
                cls._avail = (os.name == "posix"
                              and hasattr(os, "geteuid")
                              and os.geteuid() == 0
                              and CgroupBackend().writable())
            return cls._avail

    def __init__(self, name: str, cpu_shares: int, memory_mb: int,
                 chroot_dir: Optional[str] = None,
                 chroot_dirs: Tuple[str, ...] = DEFAULT_CHROOT_DIRS):
        self.name = name
        self.backend = CgroupBackend()
        self.procs_files = self.backend.create(name, cpu_shares,
                                               memory_mb)
        self.chroot_dir = chroot_dir
        self.chroot_dirs = chroot_dirs

    @classmethod
    def recover(cls, name: str) -> "IsolatedExecutor":
        """Reconstruct the executor for a re-attached task from its
        persisted cgroup name so destroy()/stats() keep working after a
        client restart (executor re-attach, task_runner.go:996)."""
        ex = cls.__new__(cls)
        ex.name = name
        ex.backend = CgroupBackend()
        ex.procs_files = []
        ex.chroot_dir = None
        ex.chroot_dirs = DEFAULT_CHROOT_DIRS
        return ex

    def stats(self) -> Dict[str, float]:
        return self.backend.stats(self.name)

    def oom_killed(self) -> bool:
        return self.backend.oom_killed(self.name)

    def destroy(self) -> None:
        self.backend.destroy(self.name)
