"""The reference's executor_process suite (tests/test_executor_process.py) against the port's
client/executor_server.py and exec_helper.py, servers on the CPU (device="cpu"), assertions unchanged.

The reference's docstring:

Out-of-proc executor: supervision that survives the client, and
exec-into-isolation.

Reference: drivers/shared/executor/executor_plugin.go (the executor as
a separate RPC-served process the driver re-dials on RecoverTask) and
executor_linux.go Exec (commands run inside the task's cgroup+chroot —
the `alloc exec` path)."""

import os
import time
import uuid

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.server import Server as _Server
from nomad_tpu_torch.client.drivers import ExecDriver
from nomad_tpu_torch.client.executor import IsolatedExecutor

isolation = pytest.mark.skipif(
    not IsolatedExecutor.available(),
    reason="requires root + writable cgroupfs")


def Server(config=None, **kw):
    # the port's Server on the CPU: the kernels' plain versions
    return _Server(config, device="cpu", **kw)


def _wait(handle, timeout=30.0):
    assert handle.wait(timeout), "task did not finish"


@isolation
def test_executor_is_separate_process(tmp_path):
    d = ExecDriver()
    h = d.start_task(
        "sep", {"command": "/bin/sh", "no_chroot": True,
                "args": ["-c", "sleep 30"]},
        {"PATH": "/usr/bin:/bin"},
        ctx={"alloc_id": uuid.uuid4().hex[:8], "task_dir": str(tmp_path),
             "resources": {"cpu": 100, "memory_mb": 64}})
    try:
        assert h.executor_pid and h.executor_pid != os.getpid()
        assert h.task_pid and h.task_pid != h.executor_pid
        # the executor runs in its own session: killing the client
        # would not deliver it a SIGHUP
        assert os.getsid(h.executor_pid) != os.getsid(0)
        st = ExecDriver._ecall(h, "Executor.State", {})
        assert not st["done"]
        # unauthenticated calls are rejected: the localhost listener
        # must not hand the task env or exec to arbitrary local users
        from nomad_tpu_torch.rpc.codec import RpcError
        with pytest.raises(RpcError):
            h.executor_rpc.call("Executor.State", {})
    finally:
        d.stop_task(h, timeout_s=2.0)
        _wait(h)


@isolation
def test_recover_redials_running_executor(tmp_path):
    """Simulated client restart: a NEW driver instance recovers the
    task from persisted state by re-dialing the still-running executor
    — no pid adoption, supervision continues."""
    d1 = ExecDriver()
    marker = tmp_path / "done.txt"
    # relative path: the task runs as an unprivileged user whose only
    # reachable directory is its (chowned) cwd — pytest's 0700 parent
    # dirs block absolute traversal
    h1 = d1.start_task(
        "durable", {"command": "/bin/sh", "no_chroot": True,
                    "args": ["-c",
                             "sleep 1; echo ok > done.txt; exit 7"]},
        {"PATH": "/usr/bin:/bin"},
        ctx={"alloc_id": uuid.uuid4().hex[:8], "task_dir": str(tmp_path),
             "resources": {"cpu": 100, "memory_mb": 64}})
    state = h1.recoverable_state()
    assert state["executor_addr"]
    # "crash" the client: drop the handle without stopping anything
    h1.executor_rpc.close()

    d2 = ExecDriver()
    h2 = d2.recover_task(state)
    assert h2 is not None, "executor should still be dialable"
    _wait(h2, timeout=30.0)
    assert h2.exit_code == 7
    assert marker.read_text().strip() == "ok", \
        "task must have kept running through the client restart"


@isolation
def test_exec_into_isolation_sees_chroot(tmp_path):
    """`alloc exec` runs INSIDE the task's isolation: the exec'd
    command sees the chroot root (the task dir as /), not the host
    filesystem."""
    task_dir = tmp_path / "task"
    task_dir.mkdir()
    (task_dir / "only-inside.txt").write_text("inside")
    host_marker = tmp_path / "host-only.txt"
    host_marker.write_text("host")
    d = ExecDriver()
    h = d.start_task(
        "jail", {"command": "/bin/sh",
                 "args": ["-c", "sleep 30"]},
        {"PATH": "/usr/bin:/bin"},
        ctx={"alloc_id": uuid.uuid4().hex[:8], "task_dir": str(task_dir),
             "resources": {"cpu": 100, "memory_mb": 64}})
    try:
        res = d.exec_in_task(h, ["/bin/sh", "-c",
                                 "cat /only-inside.txt"])
        assert res["exit_code"] == 0, res
        assert b"inside" in res["output"]
        # the host path outside the chroot is invisible
        res2 = d.exec_in_task(
            h, ["/bin/sh", "-c", f"test -e /{host_marker.name}"])
        assert res2["exit_code"] != 0
        # and the exec'd process joins the task's cgroup (verified from
        # the host — /proc isn't part of the chroot's bind allowlist):
        # while a 1.5s exec runs, the cgroup must hold more pids than
        # the task alone
        import threading

        from nomad_tpu_torch.client.executor import CgroupBackend
        procs_paths = [os.path.join(p, "cgroup.procs")
                       for p in CgroupBackend().paths_for(h.cgroup_name)
                       if os.path.exists(os.path.join(p,
                                                      "cgroup.procs"))]
        assert procs_paths

        def count_members():
            pids = set()
            for p in procs_paths:
                with open(p) as f:
                    pids.update(x for x in f.read().split() if x)
            return len(pids)

        before = count_members()
        t = threading.Thread(target=lambda: d.exec_in_task(
            h, ["/bin/sh", "-c", "sleep 1.5"], timeout_s=10.0))
        t.start()
        deadline = time.time() + 5
        grew = False
        while time.time() < deadline:
            if count_members() > before:
                grew = True
                break
            time.sleep(0.05)
        t.join()
        assert grew, "exec'd process never appeared in the task cgroup"
    finally:
        d.stop_task(h, timeout_s=2.0)
        _wait(h)


@isolation
def test_volume_mount_bound_into_chroot(tmp_path):
    """A volume_mount destination is bind-mounted inside the task's
    chroot: the task reads/writes the volume at its destination
    (taskrunner volume mounts through the executor)."""
    task_dir = tmp_path / "task"
    vol_src = tmp_path / "volsrc"
    task_dir.mkdir()
    vol_src.mkdir()
    (vol_src / "seed.txt").write_text("volume data")
    os.chmod(vol_src, 0o777)
    d = ExecDriver()
    h = d.start_task(
        "volt", {"command": "/bin/sh",
                 "args": ["-c", "cat /data/seed.txt && "
                                "echo written > /data/out.txt"]},
        {"PATH": "/usr/bin:/bin"},
        ctx={"alloc_id": uuid.uuid4().hex[:8], "task_dir": str(task_dir),
             "resources": {"cpu": 100, "memory_mb": 64},
             "volume_mounts": [{"volume": "vol",
                                "source": str(vol_src),
                                "destination": "/data",
                                "read_only": False}]})
    _wait(h)
    assert h.exit_code == 0, f"exit={h.exit_code} err={h.error}"
    # the write inside the chroot landed in the volume source
    assert (vol_src / "out.txt").read_text().strip() == "written"
    # and a read-only mount refuses writes
    h2 = d.start_task(
        "volro", {"command": "/bin/sh",
                  "args": ["-c", "echo x > /data/nope.txt"]},
        {"PATH": "/usr/bin:/bin"},
        ctx={"alloc_id": uuid.uuid4().hex[:8], "task_dir": str(task_dir),
             "resources": {"cpu": 100, "memory_mb": 64},
             "volume_mounts": [{"volume": "vol",
                                "source": str(vol_src),
                                "destination": "/data",
                                "read_only": True}]})
    _wait(h2)
    assert h2.exit_code != 0
    assert not (vol_src / "nope.txt").exists()


@isolation
def test_alloc_exec_enters_isolation_e2e(tmp_path):
    """Full stack: server + client + exec-driver job; `alloc exec`
    through the client RPC service runs inside the task's chroot
    (client/alloc_endpoint.go exec -> executor Exec)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.client import Client, ClientConfig
    from nomad_tpu_torch.server import ServerConfig

    server = Server(ServerConfig(num_schedulers=1,
                                 heartbeat_ttl_s=30.0))
    server.start()
    client = Client(server, ClientConfig(
        node_name="exec-e2e", alloc_dir=str(tmp_path)))
    client.start()
    try:
        job = mock.batch_job()
        job.id = "exec-e2e"
        tg = job.task_groups[0]
        tg.count = 1
        task = tg.tasks[0]
        task.driver = "exec"
        task.config = {"command": "/bin/sh",
                       "args": ["-c", "echo taskmark > mark.txt; "
                                      "sleep 30"]}
        job.canonicalize()
        server.register_job(job)

        deadline = time.time() + 30
        allocs = []
        while time.time() < deadline:
            allocs = server.store.allocs_by_job("default", job.id)
            if allocs and allocs[0].client_status == "running":
                break
            time.sleep(0.1)
        assert allocs and allocs[0].client_status == "running"

        svc = client.rpc_service
        out = b""
        deadline = time.time() + 15
        while time.time() < deadline:
            start = svc.exec_start({"alloc_id": allocs[0].id,
                                    "task": task.name,
                                    "cmd": ["/bin/sh", "-c",
                                            "cat /mark.txt"]})
            sid = start["session_id"]
            out = b""
            for _ in range(100):
                r = svc.exec_io({"session_id": sid, "wait_s": 0.2})
                out += r.get("stdout", b"")
                if r.get("exited"):
                    break
            if b"taskmark" in out:
                break
            time.sleep(0.3)
        assert b"taskmark" in out, out
    finally:
        client.shutdown()
        server.shutdown()


@isolation
def test_executor_logs_survive_driver_handle_loss(tmp_path):
    """Log rotation runs in the executor process, so task output
    keeps landing in the log files with no client attached."""
    task_dir = tmp_path / "task"
    log_dir = tmp_path / "logs"
    task_dir.mkdir()
    log_dir.mkdir()
    d = ExecDriver()
    h = d.start_task(
        "logger", {"command": "/bin/sh", "no_chroot": True,
                   "args": ["-c",
                            "for i in 1 2 3 4 5; do echo line-$i; "
                            "sleep 0.3; done"]},
        {"PATH": "/usr/bin:/bin"},
        ctx={"alloc_id": uuid.uuid4().hex[:8], "task_dir": str(task_dir),
             "log_dir": str(log_dir),
             "resources": {"cpu": 100, "memory_mb": 64}})
    state = h.recoverable_state()
    h.executor_rpc.close()          # client goes away mid-run

    deadline = time.time() + 20
    content = ""
    while time.time() < deadline:
        files = [f for f in os.listdir(log_dir) if "stdout" in f]
        content = "".join(
            open(os.path.join(log_dir, f)).read() for f in files)
        if "line-5" in content:
            break
        time.sleep(0.2)
    assert "line-5" in content, content
    # reconnect and reap
    d2 = ExecDriver()
    h2 = d2.recover_task(state)
    if h2 is not None:
        _wait(h2)
