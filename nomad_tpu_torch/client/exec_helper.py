"""Containment bootstrap, run as a FRESH interpreter between the client
and the task: joins the cgroup, builds the mount-ns chroot, then
execve()s the task command.

The reference re-execs its own binary for exactly this job (main.go:16
logmon/executor re-exec): running containment code via preexec_fn would
fork a multithreaded parent (the client embeds JAX), which risks
deadlocking in the child on locks held by other threads at fork time.
A spawned helper has no such baggage.

Invoked as: python -m nomad_tpu_torch.client.exec_helper  (spec JSON on
STDIN — argv is world-readable via /proc/*/cmdline and the spec can
carry secrets like VAULT_TOKEN)
spec: {procs_files: [..], chroot_dir: str|null, chroot_dirs: [..],
       command: str, args: [..], env: {..}, cwd: str|null}

NOTE: the interpreter briefly occupies the task's cgroup before
execve replaces it — memory limits below ~16MB can OOM the bootstrap
itself.
"""

import json
import os
import sys

MS_NOSUID = 0x2
MS_NODEV = 0x4
MS_NOEXEC = 0x8


def _statvfs_ms_flags(path: str) -> int:
    """Current nosuid/nodev/noexec flags of the mount at `path`, as
    MS_* bits (a remount must carry locked flags forward or the kernel
    refuses it with EPERM)."""
    try:
        st = os.statvfs(path)
    except OSError:
        return 0
    out = 0
    if st.f_flag & os.ST_NOSUID:
        out |= MS_NOSUID
    if st.f_flag & os.ST_NODEV:
        out |= MS_NODEV
    if st.f_flag & os.ST_NOEXEC:
        out |= MS_NOEXEC
    return out


def contain(spec: dict) -> None:
    os.setsid()
    for pf in spec.get("procs_files", []):
        with open(pf, "w") as f:
            f.write("0")            # 0 == the calling process
    chroot_dir = spec.get("chroot_dir")
    if chroot_dir:
        from nomad_tpu_torch.client.executor import (
            CLONE_NEWNS, MS_BIND, MS_PRIVATE, MS_RDONLY, MS_REC,
            MS_REMOUNT, _get_libc)
        import ctypes
        libc = _get_libc()
        if libc.unshare(CLONE_NEWNS) != 0:
            raise OSError(ctypes.get_errno(), "unshare(CLONE_NEWNS)")
        if libc.mount(b"none", b"/", None, MS_REC | MS_PRIVATE,
                      None) != 0:
            raise OSError(ctypes.get_errno(), "make-rprivate /")
        for src in spec.get("chroot_dirs", []):
            if not os.path.isdir(src):
                continue
            dst = chroot_dir + src
            os.makedirs(dst, exist_ok=True)
            if libc.mount(src.encode(), dst.encode(), None,
                          MS_BIND | MS_REC, None) != 0:
                raise OSError(ctypes.get_errno(), f"bind {src}")
            # the RO downgrade must not fail silently: a writable /etc
            # or /usr inside the chroot defeats the allowlist's point.
            # The kernel rejects a bind-remount that would CLEAR locked
            # flags (user namespaces, locked nosuid/nodev/noexec), so
            # re-assert the source mount's current flags alongside RO
            flags = MS_BIND | MS_REMOUNT | MS_RDONLY | _statvfs_ms_flags(dst)
            if libc.mount(src.encode(), dst.encode(), None,
                          flags, None) != 0:
                raise OSError(ctypes.get_errno(), f"remount-ro {src}")
        # volume_mount stanzas: bind each resolved volume source
        # (CSI publish target / host volume path) at its destination
        # inside the chroot (taskrunner/volume_hook + executor mounts)
        for vm in spec.get("bind_mounts") or []:
            src = os.path.realpath(vm.get("source") or "")
            dest = vm.get("destination") or ""
            if not vm.get("source") or not dest:
                continue            # malformed stanza
            if not os.path.isdir(src):
                # a missing volume source must FAIL the launch — a
                # silently skipped mount means the task writes into a
                # chroot-local stub dir and the data is lost on GC
                raise OSError(2, f"volume source missing: "
                                 f"{vm.get('source')} -> {dest}")
            dst = chroot_dir + "/" + dest.lstrip("/")
            os.makedirs(dst, exist_ok=True)
            if libc.mount(src.encode(), dst.encode(), None,
                          MS_BIND | MS_REC, None) != 0:
                raise OSError(ctypes.get_errno(),
                              f"bind volume {src} -> {dest}")
            if vm.get("read_only"):
                flags = MS_BIND | MS_REMOUNT | MS_RDONLY \
                    | _statvfs_ms_flags(dst)
                if libc.mount(src.encode(), dst.encode(), None,
                              flags, None) != 0:
                    raise OSError(ctypes.get_errno(),
                                  f"remount-ro volume {dest}")
        os.makedirs(chroot_dir + "/tmp", exist_ok=True)
        os.makedirs(chroot_dir + "/dev", exist_ok=True)
        for dev in ("null", "zero", "urandom"):
            src = "/dev/" + dev
            dst = chroot_dir + src
            if not os.path.exists(dst):
                open(dst, "a").close()
            libc.mount(src.encode(), dst.encode(), None, MS_BIND, None)
        os.chroot(chroot_dir)
        os.chdir("/")
    else:
        if spec.get("bind_mounts"):
            # without a chroot there is nowhere to bind the volumes —
            # starting anyway would silently write to raw host paths
            raise RuntimeError(
                "volume mounts require chroot isolation")
        if spec.get("cwd"):
            os.chdir(spec["cwd"])


DEFAULT_PATH = "/usr/local/bin:/usr/bin:/bin:/usr/sbin:/sbin"


def resolve_user(name: str):
    """(uid, gid, home) for the task's `user` stanza. Resolved BEFORE
    the chroot so the host's passwd database answers."""
    import pwd
    rec = pwd.getpwnam(name)
    return rec.pw_uid, rec.pw_gid, rec.pw_dir


def chown_tree(path: str, uid: int, gid: int) -> None:
    # lchown ONLY: this runs as root, and a task artifact can smuggle a
    # symlink to any host file — following it would chown /etc/shadow
    # to the task user
    os.lchown(path, uid, gid)
    for root, dirs, files in os.walk(path):
        for name in dirs + files:
            try:
                os.lchown(os.path.join(root, name), uid, gid)
            except OSError:
                pass


def main() -> None:
    spec = json.loads(sys.stdin.read())
    # user switching (drivers/shared/executor/executor.go: the task
    # runs as the jobspec `user`, default unprivileged — an isolated
    # task must not inherit the agent's root): resolve before the
    # chroot, chown the task's writable tree, drop after containment
    user = spec.get("user") or ""
    creds = None
    if user and hasattr(os, "geteuid") and os.geteuid() == 0:
        uid, gid, _home = resolve_user(user)
        creds = (uid, gid)
        for d in spec.get("chown_dirs") or []:
            if os.path.isdir(d):
                chown_tree(d, uid, gid)
        # supplementary groups from the HOST group database — after
        # the chroot, a task-shipped etc/group could grant itself
        # gid 0 through this lookup
        os.initgroups(user, gid)
    contain(spec)
    env = dict(spec.get("env") or {})
    # execvpe resolves the command via the TASK env's PATH; a jobspec
    # that omits PATH would fail to launch here while the raw_exec
    # fallback (which inherits the client env) would succeed — resolve
    # against a sane default instead
    env.setdefault("PATH", DEFAULT_PATH)
    if creds is not None:
        uid, gid = creds
        os.setgid(gid)
        os.setuid(uid)
        env.setdefault("USER", user)
        env.setdefault("LOGNAME", user)
    cmd = spec["command"]
    os.execvpe(cmd, [cmd] + list(spec.get("args", [])), env)


if __name__ == "__main__":
    main()
