"""The reference's executor suite (tests/test_executor.py) against the port's
client/executor.py, servers on the CPU (device="cpu"), assertions unchanged.

The reference's docstring:

Executor isolation: cgroup limits, OOM kill reporting, chroot
containment, stats, graceful fallback (reference:
drivers/shared/executor/executor_linux.go).

Tests requiring root + writable cgroupfs skip elsewhere.
"""

import os
import time
import uuid

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.client.drivers import ExecDriver
from nomad_tpu_torch.client.executor import CgroupBackend, IsolatedExecutor

isolation = pytest.mark.skipif(
    not IsolatedExecutor.available(),
    reason="requires root + writable cgroupfs")


def _aid() -> str:
    """An alloc id of this run's own: a task's cgroup is named after the
    id's first 8 characters, so tests that run at the same time (another
    checkout's, the JAX package's) never meet in one cgroup."""
    return uuid.uuid4().hex[:8]


def _memory_limit_written(limit_bytes: int, cg_name: str) -> bool:
    """True when the task's own live cgroup carries exactly this limit —
    the guard that separates 'kernel never delivered the OOM kill'
    (environment, skip) from 'executor silently stopped applying
    limits' (regression, fail)."""
    for base in CgroupBackend().paths_for(cg_name):
        for leaf in ("memory.max", "memory.limit_in_bytes"):
            p = os.path.join(base, leaf)
            try:
                with open(p) as f:
                    if f.read().strip() == str(limit_bytes):
                        return True
            except OSError:
                continue
    return False


def _cgroup_memory_delegated() -> bool:
    """True when the memory controller is actually delegated into the
    executor's parent cgroup — writable cgroupfs alone is not enough
    for an OOM kill: some containers mount cgroupfs read-write but
    never delegate +memory, so memory.max silently doesn't exist and
    the kernel lets the hog run."""
    from nomad_tpu_torch.client.executor import CG_PARENT
    cg = CgroupBackend()
    if not cg.writable():
        return False
    try:
        if cg.v2:
            cg._enable_v2_controllers()
            with open(os.path.join(cg.root, CG_PARENT,
                                   "cgroup.controllers")) as f:
                return "memory" in f.read().split()
        return os.path.isdir(os.path.join(cg.root, "memory"))
    except OSError:
        return False


def _wait(handle, timeout=30.0):
    assert handle.wait(timeout), "task did not finish"


@isolation
def test_memory_limit_kills_task(tmp_path):
    """The contract VERDICT asked for: a task exceeding memory_mb is
    killed by the kernel and reported as OOM."""
    # probed here, not in a skipif: the v2 probe WRITES
    # cgroup.subtree_control, which must not happen at collection time
    if not _cgroup_memory_delegated():
        pytest.skip("memory controller not delegated — the kernel "
                    "cannot OOM-kill here")
    d = ExecDriver()
    aid = _aid()
    h = d.start_task(
        "hog",
        {"command": "/usr/bin/python3", "no_chroot": True,
         "args": ["-c", "x = bytearray(256 * 1024 * 1024); "
                        "import time; time.sleep(30)"]},
        {"PATH": "/usr/bin:/bin"},
        ctx={"alloc_id": aid, "task_dir": str(tmp_path),
             "resources": {"cpu": 500, "memory_mb": 32}})
    # record whether the 32 MB limit actually landed in a live task
    # cgroup while the hog runs — a surviving hog is only attributable
    # to the environment if the executor DID write the limit; a
    # silent-skip regression (limit never written) must still FAIL
    limit_seen = False
    for _ in range(20):
        if _memory_limit_written(32 * 1024 * 1024, f"{aid}-hog"):
            limit_seen = True
            break
        if h.wait(0.25):        # already dead (the OOM landed fast)
            break
    # an OOM kill lands within seconds; a hog that SURVIVES sleeps 30 s
    # and exits 0. Either survival shape — clean exit or still napping
    # past the sleep — with the limit verifiably written means this
    # container's kernel path never delivers the OOM kill
    # (gVisor-style sandboxes, overcommit-always hosts)
    finished = h.wait(40.0)
    if not finished or h.exit_code == 0:
        d.stop_task(h)
        assert limit_seen, (
            "hog survived AND no task cgroup ever carried the 32 MB "
            "limit — the executor stopped applying memory limits "
            "(regression), not an environment gap")
        pytest.skip("cgroup memory limit not enforced by this "
                    "kernel/container (no OOM kill delivered)")
    assert h.exit_code not in (0, None), f"exit={h.exit_code}"
    assert h.exit_code == 137 or h.exit_code < 0
    assert "OOM" in (h.error or ""), h.error


@isolation
def test_within_limit_runs_and_reports_stats(tmp_path):
    d = ExecDriver()
    h = d.start_task(
        "ok",
        {"command": "/usr/bin/python3", "no_chroot": True,
         "args": ["-c", "x = bytearray(8 * 1024 * 1024); "
                        "import time; time.sleep(2)"]},
        {"PATH": "/usr/bin:/bin"},
        ctx={"alloc_id": _aid(), "task_dir": str(tmp_path),
             "resources": {"cpu": 500, "memory_mb": 256}})
    time.sleep(1.0)
    stats = d.stats(h)
    assert stats.get("memory_bytes", 0) > 1024 * 1024, stats
    _wait(h)
    assert h.exit_code == 0


@isolation
def test_cgroup_cleaned_up_after_exit(tmp_path):
    d = ExecDriver()
    aid = _aid()
    h = d.start_task(
        "gone",
        {"command": "/bin/true", "no_chroot": True},
        {},
        ctx={"alloc_id": aid, "task_dir": str(tmp_path),
             "resources": {"cpu": 100, "memory_mb": 64}})
    _wait(h)
    time.sleep(0.3)
    be = CgroupBackend()
    for base in be.paths_for(f"{aid}-gone"):
        assert not os.path.exists(base), f"cgroup leaked: {base}"


@isolation
def test_chroot_containment(tmp_path):
    """The task sees the task dir as its root: host paths outside the
    bind allowlist are invisible."""
    task_dir = tmp_path / "task"
    task_dir.mkdir()
    marker = tmp_path / "host-secret.txt"
    marker.write_text("host data")
    d = ExecDriver()
    h = d.start_task(
        "jailed",
        {"command": "/bin/sh",
         "args": ["-c",
                  f"test -e /{marker.name} && exit 3; "
                  "test -d /bin || exit 4; "
                  "echo jailed > /inside.txt; exit 0"]},
        {"PATH": "/usr/bin:/bin"},
        ctx={"alloc_id": _aid(), "task_dir": str(task_dir),
             "resources": {"cpu": 100, "memory_mb": 64}})
    _wait(h)
    assert h.exit_code == 0, f"exit={h.exit_code} err={h.error}"
    # the file the task wrote at its / landed in the task dir
    assert (task_dir / "inside.txt").read_text().strip() == "jailed"
    # and the bind mounts did not leak into the host namespace
    assert not os.path.ismount(str(task_dir / "bin"))


@isolation
def test_stop_task_tears_down_cgroup(tmp_path):
    d = ExecDriver()
    aid = _aid()
    h = d.start_task(
        "stopme",
        {"command": "/bin/sleep", "args": ["30"], "no_chroot": True},
        {},
        ctx={"alloc_id": aid, "task_dir": str(tmp_path),
             "resources": {"cpu": 100, "memory_mb": 64}})
    time.sleep(0.3)
    d.stop_task(h, timeout_s=3.0)
    _wait(h, 5.0)
    be = CgroupBackend()
    for base in be.paths_for(f"{aid}-stopme"):
        assert not os.path.exists(base), f"cgroup leaked: {base}"


@isolation
def test_recover_task_reclaims_cgroup(tmp_path):
    """After a client restart, RecoverTask rebuilds the cgroup owner
    from persisted state so the dir is reaped instead of leaking."""
    d = ExecDriver()
    aid = _aid()
    h = d.start_task(
        "recov",
        {"command": "/bin/sleep", "args": ["20"], "no_chroot": True},
        {},
        ctx={"alloc_id": aid, "task_dir": str(tmp_path),
             "resources": {"cpu": 100, "memory_mb": 64}})
    time.sleep(0.3)
    state = h.recoverable_state()
    assert state.get("cgroup") == f"{aid}-recov"
    # simulate a restarted client: a fresh driver re-attaches by state
    d2 = ExecDriver()
    h2 = d2.recover_task(state)
    assert h2 is not None
    d2.stop_task(h2, timeout_s=3.0)
    h2.wait(5.0)
    time.sleep(0.5)
    be = CgroupBackend()
    for base in be.paths_for(f"{aid}-recov"):
        assert not os.path.exists(base), f"cgroup leaked: {base}"
    # the original handle's waiter also cleans up; no crash on double
    d.stop_task(h, timeout_s=1.0)


def test_fingerprint_reports_isolation_mode():
    d = ExecDriver()
    fp = d.fingerprint()
    assert fp["driver.exec"] == "1"
    assert fp["driver.exec.isolation"] in ("cgroups", "none")


def test_no_isolation_falls_back(tmp_path):
    """Explicit opt-out (and non-root hosts) run the plain path."""
    d = ExecDriver()
    h = d.start_task(
        "plain",
        {"command": "/bin/true", "no_isolation": True},
        {}, ctx={"task_dir": str(tmp_path)})
    _wait(h)
    assert h.exit_code == 0
    assert getattr(h, "executor", None) is None


@isolation
def test_isolated_task_runs_as_unprivileged_user(tmp_path):
    """User switching (drivers/shared/executor/executor.go): with no
    `user` stanza an isolated task drops to an unprivileged account —
    running workloads as the agent's root silently is not acceptable —
    and its task dir is chowned so it stays writable."""
    d = ExecDriver()
    out = tmp_path / "who"
    out.mkdir()
    h = d.start_task(
        "whoami",
        {"command": "/bin/sh", "no_chroot": True,
         "args": ["-c", "id -u > uid.txt; touch proof.txt"]},
        {"PATH": "/usr/bin:/bin"},
        ctx={"alloc_id": _aid(), "task_dir": str(out),
             "resources": {"cpu": 200, "memory_mb": 64}})
    _wait(h)
    assert h.exit_code == 0, h.error
    uid = int((out / "uid.txt").read_text().strip())
    assert uid != 0, "isolated task ran as root"
    import pwd
    assert uid == pwd.getpwnam("nobody").pw_uid
    # the task could write its own dir because the helper chowned it
    assert (out / "proof.txt").exists()
    assert (out / "proof.txt").stat().st_uid == uid


@isolation
def test_user_stanza_overrides_default(tmp_path):
    d = ExecDriver()
    out = tmp_path / "asroot"
    out.mkdir()
    h = d.start_task(
        "asroot",
        {"command": "/bin/sh", "no_chroot": True, "user": "root",
         "args": ["-c", "id -u > uid.txt"]},
        {"PATH": "/usr/bin:/bin"},
        ctx={"alloc_id": _aid(), "task_dir": str(out),
             "resources": {"cpu": 200, "memory_mb": 64}})
    _wait(h)
    assert h.exit_code == 0, h.error
    assert int((out / "uid.txt").read_text().strip()) == 0
