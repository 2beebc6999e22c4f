"""Host side of the driver plugin boundary.

ExternalDriver presents the exact in-proc driver interface
(start_task/stop_task/recover_task + TaskHandle semantics) while the
work happens in a supervised subprocess — the drivermanager role
(client/pluginmanager/drivermanager): launch with the handshake cookie,
parse the handshake line, reconnect-and-relaunch on crash.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

from ..rpc.client import RpcClient, RpcError
from ..utils.locks import make_lock
from .base import (HANDSHAKE_COOKIE_KEY, HANDSHAKE_COOKIE_VALUE,
                   HANDSHAKE_PREFIX)

LOG = logging.getLogger("nomad_tpu.plugins")


class ProxyHandle:
    """Client-side stand-in for a plugin-held TaskHandle."""

    def __init__(self, driver: "ExternalDriver", handle_id: str,
                 task_name: str, config: dict, started_at: float):
        self.id = handle_id
        self.driver_name = driver.name
        self._driver = driver
        self.task_name = task_name
        self.config = config
        self.started_at = started_at
        self.finished_at = 0.0
        self.exit_code: Optional[int] = None
        self._done = threading.Event()

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self._done.is_set():
            return True
        deadline = None if timeout is None else time.time() + timeout
        while deadline is None or time.time() < deadline:
            chunk = 30.0 if deadline is None \
                else min(30.0, deadline - time.time())
            if chunk <= 0:
                break
            try:
                res = self._driver.call(
                    "Driver.WaitTask",
                    {"handle_id": self.id, "timeout_s": chunk},
                    timeout_s=chunk + 15.0)
            except RpcError:
                # plugin died: the task is gone; report a failure exit
                self.exit_code = 137
                self.finished_at = time.time()
                self._done.set()
                return True
            if res.get("done"):
                self.exit_code = res.get("exit_code")
                self.finished_at = res.get("finished_at") or time.time()
                self._done.set()
                return True
        return False

    def done(self) -> bool:
        return self._done.is_set()

    def recoverable_state(self) -> dict:
        return {"id": self.id, "task_name": self.task_name,
                "driver": self.driver_name, "config": dict(self.config),
                "pid": None, "started_at": self.started_at,
                "plugin": True}


class ExternalDriver:
    """Driver running behind the plugin process boundary."""

    def __init__(self, driver_name: str, python: str = sys.executable):
        self.name = driver_name
        self.python = python
        self._lock = make_lock()
        self._proc: Optional[subprocess.Popen] = None
        self._rpc: Optional[RpcClient] = None

    # -- process supervision ------------------------------------------
    def _ensure_running(self) -> RpcClient:
        with self._lock:
            if self._rpc is not None and self._proc is not None \
                    and self._proc.poll() is None:
                return self._rpc
            if self._proc is not None:
                LOG.warning("driver plugin %s died (rc=%s); relaunching",
                            self.name, self._proc.poll())
            env = dict(os.environ)
            env[HANDSHAKE_COOKIE_KEY] = HANDSHAKE_COOKIE_VALUE
            self._proc = subprocess.Popen(
                [self.python, "-m", "nomad_tpu_torch.plugins.launcher",
                 self.name],
                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True,
                cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))))
            line = self._proc.stdout.readline().strip()
            if not line.startswith(HANDSHAKE_PREFIX):
                # kill the half-started process or every retry leaks a
                # live orphan
                self._proc.kill()
                self._proc.wait()
                self._proc = None
                raise RuntimeError(
                    f"driver plugin {self.name} bad handshake: {line!r}")
            addr = line[len(HANDSHAKE_PREFIX):]
            self._rpc = RpcClient(addr)
            return self._rpc

    def call(self, method: str, args: dict, timeout_s: float = 30.0):
        try:
            return self._ensure_running().call(method, args,
                                               timeout_s=timeout_s)
        except RpcError:
            # retry once: a killed plugin may not show in poll() for a
            # moment — after the reap window _ensure_running relaunches
            # it (operations on lost handles then fail unknown-handle,
            # which callers map to task-lost); a transient connection
            # drop to a live plugin just redials
            time.sleep(0.1)
            with self._lock:
                if self._proc is not None and self._proc.poll() is not None \
                        and self._rpc is not None:
                    self._rpc.close()
                    self._rpc = None
            return self._ensure_running().call(method, args,
                                               timeout_s=timeout_s)

    def shutdown(self) -> None:
        with self._lock:
            if self._rpc is not None:
                self._rpc.close()
                self._rpc = None
            if self._proc is not None and self._proc.poll() is None:
                self._proc.terminate()
                try:
                    self._proc.wait(timeout=3)
                except subprocess.TimeoutExpired:
                    self._proc.kill()
            self._proc = None

    # -- driver interface ---------------------------------------------
    def fingerprint(self) -> Dict[str, str]:
        return self.call("Driver.Fingerprint", {})["attributes"]

    def config_spec(self):
        """The plugin's declared config schema, fetched once over the
        boundary (plugins/base ConfigSchema) and cached."""
        cached = getattr(self, "_config_spec", None)
        if cached is not None:
            return cached
        from .hclspec import spec_from_wire
        wire = self.call("Driver.ConfigSchema", {}).get("schema")
        self._config_spec = spec_from_wire(wire) if wire else {}
        return self._config_spec

    def start_task(self, task_name: str, config: dict, env: dict,
                   ctx: Optional[dict] = None):
        try:
            res = self.call("Driver.StartTask",
                            {"task_name": task_name, "config": config,
                             "env": env, "ctx": ctx})
        except RpcError as e:
            raise RuntimeError(str(e))
        h = ProxyHandle(self, res["handle_id"], task_name, config,
                        res.get("started_at") or time.time())
        return h

    def stop_task(self, handle, timeout_s: float = 5.0) -> None:
        try:
            self.call("Driver.StopTask",
                      {"handle_id": handle.id, "timeout_s": timeout_s},
                      timeout_s=timeout_s + 10.0)
        except RpcError:
            pass
        handle.wait(timeout_s)

    def recover_task(self, state: dict):
        try:
            res = self.call("Driver.RecoverTask", {"state": state})
        except RpcError:
            return None
        if not res.get("handle_id"):
            return None
        return ProxyHandle(self, res["handle_id"], state.get("task_name", ""),
                           state.get("config") or {},
                           res.get("started_at") or time.time())
