"""The client agent's RPC service: logs/fs/exec served to SERVERS that
forward user requests for allocs living on this node.

Reference topology: servers forward fs/logs/exec RPCs to the owning
client (nomad/client_fs_endpoint.go, client/alloc_endpoint.go:163
Allocations.Exec; the client-side handlers live in
client/fs_endpoint.go / client/alloc_endpoint.go). Here the client
runs its own RPC listener (rpc/server.py with a custom method table)
and advertises its address on the node record; the reference reuses
the client->server yamux session instead, but the listener gives the
same reachability with the transport this codebase already has.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from . import fs_service


def _frame_wire(fr: Dict) -> Dict:
    # msgpack carries bytes natively; keep frames wire-shaped
    return fr


class ClientRpcService:
    def __init__(self, client):
        self.client = client
        self.exec_sessions = fs_service.ExecRegistry()

    # -- helpers -------------------------------------------------------
    def _base(self, alloc_id: str) -> str:
        base = self.client.alloc_base(alloc_id)
        if base is None:
            raise KeyError(f"alloc {alloc_id[:8]} not on this node")
        return base

    def _task_runner(self, alloc_id: str, task: str):
        runner = self.client.runners.get(alloc_id)
        if runner is None:
            raise KeyError(f"alloc {alloc_id[:8]} not on this node")
        for tr in runner.task_runners:
            if tr.task.name == task or not task:
                return runner, tr
        raise KeyError(f"unknown task {task!r} for alloc {alloc_id[:8]}")

    # -- fs/logs -------------------------------------------------------
    def fs_logs(self, args: Dict) -> Dict:
        data, total = fs_service.read_logs(
            self._base(args["alloc_id"]), args["task"],
            args.get("type", "stdout"), int(args.get("offset", 0)))
        return {"Data": data, "Offset": total}

    def fs_list(self, args: Dict) -> Dict:
        out = fs_service.list_dir(self._base(args["alloc_id"]),
                                  args.get("path", "/"))
        return {"Entries": out}

    def fs_cat(self, args: Dict) -> Dict:
        data = fs_service.cat_file(self._base(args["alloc_id"]),
                                   args.get("path", "/"))
        return {"Data": data}

    def fs_stream(self, args: Dict) -> Dict:
        frames = fs_service.stream_frames(
            self._base(args["alloc_id"]),
            args.get("path"), int(args.get("offset", 0)),
            task=args.get("task", ""),
            log_type=args.get("log_type", ""),
            wait_s=float(args.get("wait_s", 0.0)))
        return {"Frames": [_frame_wire(f) for f in frames]}

    # -- exec (client/alloc_endpoint.go:163) ---------------------------
    def exec_start(self, args: Dict) -> Dict:
        alloc_id = args["alloc_id"]
        task = args.get("task", "")
        argv = list(args.get("cmd") or [])
        if not argv:
            raise ValueError("exec requires a command")
        runner, tr = self._task_runner(alloc_id, task)
        if tr.task.driver in ("mock", "mock_driver"):
            sess = fs_service.MockExecSession(argv)
        elif hasattr(tr.driver, "exec_in_task") and \
                getattr(tr.handle, "executor_rpc", None) is not None:
            # exec INSIDE the task's isolation through the out-of-proc
            # executor (same cgroup + chroot view — executor_linux.go
            # Exec)
            sess = fs_service.TaskExecSession(tr.driver, tr.handle,
                                              argv)
        else:
            from .taskenv import build_task_env
            task_path, _local, secrets = \
                runner.alloc_dir.task_paths(tr.task.name)
            env = build_task_env(
                runner.alloc, tr.task, self.client.node,
                alloc_dir=runner.alloc_dir.shared,
                task_dir=task_path, secrets_dir=secrets)
            # SCRUBBED env, same stance as task launches: only the
            # task's own variables plus a sane PATH — merging the agent
            # process env would hand an alloc-exec caller the agent's
            # credentials. This branch is the fallback for drivers
            # without an isolation boundary (raw_exec); isolated exec
            # tasks take the TaskExecSession path above, inside the
            # chroot/cgroup.
            env.setdefault(
                "PATH", "/usr/local/bin:/usr/bin:/bin:/usr/sbin:/sbin")
            sess = fs_service.ExecSession(argv, cwd=task_path, env=env)
        self.exec_sessions.add(sess)
        return {"session_id": sess.id}

    def exec_io(self, args: Dict) -> Dict:
        sess = self.exec_sessions.get(args["session_id"])
        if sess is None:
            raise KeyError("unknown exec session")
        stdin = args.get("stdin") or b""
        if stdin or args.get("close_stdin"):
            sess.write_stdin(bytes(stdin),
                             close=bool(args.get("close_stdin")))
        sig = args.get("signal")
        if sig:
            sess.signal(int(sig))
        out = sess.poll(wait_s=float(args.get("wait_s", 0.0)))
        if out["exited"]:
            self.exec_sessions.remove(args["session_id"])
        return out

    def exec_stop(self, args: Dict) -> Dict:
        self.exec_sessions.remove(args["session_id"])
        return {}

    # -- alloc lifecycle (client/alloc_endpoint.go Restart/Signal) -----
    def _task_runners_for(self, alloc_id: str, task: str):
        runner = self.client.runners.get(alloc_id)
        if runner is None:
            raise KeyError(f"alloc {alloc_id[:8]} not on this node")
        out = [tr for tr in runner.task_runners
               if not task or tr.task.name == task]
        if not out:
            raise KeyError(f"unknown task {task!r}")
        return out

    def alloc_signal(self, args: Dict) -> Dict:
        """Deliver a signal to the task process(es). Unknown signal
        names are an ERROR — silently substituting a default would
        deliver the wrong signal while reporting success."""
        import signal as _signal
        sig = args.get("signal") or _signal.SIGUSR1
        if isinstance(sig, str):
            name = sig.upper()
            if not name.startswith("SIG"):
                name = f"SIG{name}"
            resolved = getattr(_signal, name, None)
            if resolved is None:
                raise ValueError(f"unknown signal {sig!r}")
            sig = resolved
        delivered = 0
        for tr in self._task_runners_for(args["alloc_id"],
                                         args.get("task", "")):
            proc = getattr(tr.handle, "proc", None) if tr.handle else None
            if proc is not None:
                try:
                    proc.send_signal(int(sig))
                    delivered += 1
                except (ProcessLookupError, OSError):
                    pass
        return {"delivered": delivered}

    def alloc_restart(self, args: Dict) -> Dict:
        """Restart the task(s): flag the runner for an unconditional
        restart (any exit code, outside the policy budget) and stop
        the process; the run loop brings it straight back."""
        restarted = 0
        for tr in self._task_runners_for(args["alloc_id"],
                                         args.get("task", "")):
            h = tr.handle
            if h is None:
                continue
            tr._force_restart = True
            try:
                tr.driver.stop_task(h, 5.0)
                restarted += 1
            except Exception:
                tr._force_restart = False
        return {"restarted": restarted}

    # -- host/alloc stats (command/agent/stats_endpoint.go +
    # client/alloc_endpoint.go Stats) -----------------------
    def stats_host(self, args: Dict) -> Dict:
        """This node's latest HostStats sample; reports the sampler
        dark (enabled: False) under the kill switch instead of erroring
        — a fleet-wide poller must distinguish 'off' from 'down'."""
        hs = getattr(self.client, "host_stats", None)
        if hs is None:
            return {"enabled": False}
        out = hs.host_stats()
        out["enabled"] = True
        if args.get("history"):
            out["history"] = hs.history(
                last=int(args.get("n", 0)) or None)
        return out

    def stats_alloc(self, args: Dict) -> Dict:
        hs = getattr(self.client, "host_stats", None)
        if hs is None:
            return {"enabled": False, "stats": None}
        stats = hs.alloc_stats(args["alloc_id"])
        if stats is None:
            # distinguish "not on this node" (a real routing error)
            # from "running but no usage reported" (driver without a
            # stats() hook, or the first sample hasn't landed): the
            # latter answers cleanly with stats: None — the shape the
            # CLI renders as "no live usage reported"
            aid = args["alloc_id"]
            if not any(rid.startswith(aid)
                       for rid in self.client.runners):
                raise KeyError(
                    f"alloc {aid[:8]} not on this node")
        return {"enabled": True, "stats": stats}

    # -- the method table ---------------------------------------------
    def rpc_methods(self) -> Dict:
        return {
            "ClientFS.Logs": self.fs_logs,
            "ClientFS.List": self.fs_list,
            "ClientFS.Cat": self.fs_cat,
            "ClientFS.Stream": self.fs_stream,
            "ClientExec.Start": self.exec_start,
            "ClientExec.Io": self.exec_io,
            "ClientExec.Stop": self.exec_stop,
            "ClientAlloc.Signal": self.alloc_signal,
            "ClientAlloc.Restart": self.alloc_restart,
            "ClientStats.Host": self.stats_host,
            "ClientStats.Alloc": self.stats_alloc,
        }
