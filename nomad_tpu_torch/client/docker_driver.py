"""Docker task driver over the Engine HTTP API.

Reference surface: drivers/docker/driver.go (4.7k LoC) — image pull,
container create/start/stop/remove, port maps, resource limits,
stats, log collection, RecoverTask re-attach, and the orphan-container
reconciler (drivers/docker/reconciler.go: containers labeled as
nomad-managed whose alloc no longer exists get stopped). This driver
speaks the Engine API directly over the unix socket (no docker SDK in
the image); it registers only when a reachable dockerd advertises a
version, and fingerprints as absent otherwise.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..plugins.hclspec import Attr as _SpecAttr
from .drivers import TaskHandle

LOG = logging.getLogger("nomad_tpu.docker")

DEFAULT_SOCKET = "/var/run/docker.sock"
LABEL_ALLOC = "com.nomad-tpu.alloc_id"
LABEL_TASK = "com.nomad-tpu.task"


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, path: str, timeout: float = 60.0):
        super().__init__("localhost", timeout=timeout)
        self._path = path

    def connect(self):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self._path)
        self.sock = sock


class DockerAPIError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"docker API {status}: {message}")
        self.status = status


class DockerAPI:
    """Minimal Engine API client (one connection per request — the
    engine supports keep-alive but per-request keeps stream handling
    simple)."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET):
        self.socket_path = socket_path

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 timeout: float = 60.0) -> Tuple[int, bytes]:
        conn = _UnixHTTPConnection(self.socket_path, timeout=timeout)
        try:
            data = json.dumps(body).encode() if body is not None else None
            headers = {"Content-Type": "application/json"} if data else {}
            conn.request(method, path, body=data, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            return resp.status, payload
        finally:
            conn.close()

    def call(self, method: str, path: str, body: Optional[dict] = None,
             timeout: float = 60.0):
        status, payload = self._request(method, path, body, timeout)
        if status >= 400:
            try:
                msg = json.loads(payload).get("message", payload.decode())
            except Exception:
                msg = payload.decode("utf-8", "replace")
            raise DockerAPIError(status, msg)
        if not payload:
            return None
        try:
            return json.loads(payload)
        except json.JSONDecodeError:
            return payload

    # -- surface -------------------------------------------------------
    def version(self) -> Optional[dict]:
        try:
            return self.call("GET", "/version", timeout=3.0)
        except (OSError, DockerAPIError):
            return None

    @staticmethod
    def normalize_image(image: str) -> str:
        """Tagless references mean :latest (docker's own resolution)."""
        if ":" not in image.rsplit("/", 1)[-1]:
            return image + ":latest"
        return image

    def pull(self, image: str, timeout: float = 600.0) -> None:
        image = self.normalize_image(image)
        # the create-image endpoint answers 200 immediately and streams
        # progress JSON; FAILURES arrive as error messages inside the
        # stream, not as an HTTP status
        status, payload = self._request(
            "POST", f"/images/create?fromImage={image}", timeout=timeout)
        if status >= 400:
            raise DockerAPIError(status, payload.decode("utf-8", "replace"))
        for line in payload.decode("utf-8", "replace").splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(msg, dict) and ("error" in msg
                                          or "errorDetail" in msg):
                detail = msg.get("error") or \
                    (msg.get("errorDetail") or {}).get("message", "")
                raise DockerAPIError(500, f"pull of {image} failed: "
                                          f"{detail}")

    def image_exists(self, image: str) -> bool:
        try:
            self.call("GET", f"/images/{image}/json", timeout=10.0)
            return True
        except DockerAPIError as e:
            if e.status == 404:
                return False
            raise

    def create_container(self, name: str, spec: dict) -> str:
        out = self.call("POST", f"/containers/create?name={name}", spec)
        return out["Id"]

    def start(self, cid: str) -> None:
        self.call("POST", f"/containers/{cid}/start")

    def stop(self, cid: str, timeout_s: int = 5) -> None:
        self.call("POST", f"/containers/{cid}/stop?t={int(timeout_s)}",
                  timeout=timeout_s + 15.0)

    def kill(self, cid: str) -> None:
        self.call("POST", f"/containers/{cid}/kill")

    def remove(self, cid: str, force: bool = True) -> None:
        self.call("DELETE",
                  f"/containers/{cid}?force={'true' if force else 'false'}")

    def inspect(self, cid: str) -> dict:
        return self.call("GET", f"/containers/{cid}/json")

    def wait(self, cid: str, timeout: float = 86400.0) -> int:
        out = self.call("POST", f"/containers/{cid}/wait",
                        timeout=timeout)
        return int(out.get("StatusCode", -1))

    def stats(self, cid: str) -> dict:
        return self.call("GET", f"/containers/{cid}/stats?stream=false",
                         timeout=20.0) or {}

    def list_containers(self, label: Optional[str] = None,
                        all_: bool = True) -> List[dict]:
        path = f"/containers/json?all={'true' if all_ else 'false'}"
        if label:
            filters = json.dumps({"label": [label]})
            from urllib.parse import quote
            path += f"&filters={quote(filters)}"
        return self.call("GET", path) or []

    def logs(self, cid: str, since: int = 0) -> Tuple[bytes, bytes]:
        """(stdout, stderr) since the unix timestamp — demuxes the
        engine's 8-byte-header stream framing."""
        status, payload = self._request(
            "GET",
            f"/containers/{cid}/logs?stdout=true&stderr=true&since={since}",
            timeout=30.0)
        if status >= 400:
            raise DockerAPIError(status,
                                 payload.decode("utf-8", "replace"))
        out = [b"", b""]
        i = 0
        while i + 8 <= len(payload):
            stream, size = struct.unpack(">BxxxL", payload[i:i + 8])
            chunk = payload[i + 8:i + 8 + size]
            if stream == 2:
                out[1] += chunk
            else:
                out[0] += chunk
            i += 8 + size
        if i == 0 and payload:          # tty containers: raw stream
            out[0] = payload
        return out[0], out[1]


def _pid_is_docklog(pid, cid: str = "") -> bool:
    """A recycled pid must not masquerade as a live docklog: verify
    the process runs the docklog module FOR THIS CONTAINER (the
    container id rides argv precisely so this check can tell two
    docklogs apart after pid reuse)."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            cmdline = f.read()
        if b"nomad_tpu_torch.client.docklog" not in cmdline:
            return False
        return (cid[:12].encode() in cmdline) if cid else True
    except OSError:
        return False


class DockerDriver:
    """drivers/docker as a nomad_tpu task driver. Registers only when
    dockerd answers /version (fingerprint absent otherwise — the
    scheduler's DriverChecker then filters such nodes)."""

    name = "docker"
    CONFIG_SPEC = {
        "image": _SpecAttr("string", required=True),
        "command": _SpecAttr("string"),
        "args": _SpecAttr("list(string)", default=[]),
        # open maps: user-chosen keys (a Block would reject them all)
        "port_map": _SpecAttr("any"),
        "network_mode": _SpecAttr("string"),
        "force_pull": _SpecAttr("bool", default=False),
        "labels": _SpecAttr("any"),
        # "host:container[:ro]" bind specs (drivers/docker volumes)
        "volumes": _SpecAttr("list(string)", default=[]),
    }

    def __init__(self, socket_path: str = DEFAULT_SOCKET):
        self.api = DockerAPI(socket_path)
        self._version = self.api.version()
        self._reconciler: Optional[threading.Thread] = None
        self._reconcile_stop = threading.Event()

    def available(self) -> bool:
        return self._version is not None

    def fingerprint(self) -> Dict[str, str]:
        if not self.available():
            return {}
        return {"driver.docker": "1",
                "driver.docker.version":
                    str(self._version.get("Version", "unknown"))}

    # -- port maps -----------------------------------------------------
    @staticmethod
    def _port_bindings(port_map: Dict, alloc_networks: List) -> Tuple[Dict, Dict]:
        """(ExposedPorts, PortBindings): container port label->host port
        from the alloc's reserved/dynamic port offers
        (drivers/docker port_map semantics: port_map maps LABEL ->
        container port; the alloc network supplies the host port for
        that label)."""
        from .drivers import resolve_host_ports
        exposed: Dict[str, dict] = {}
        bindings: Dict[str, list] = {}
        host_ports = resolve_host_ports(alloc_networks)
        for label, container_port in (port_map or {}).items():
            hp = host_ports.get(label)
            if hp is None:
                continue
            key = f"{int(container_port)}/tcp"
            exposed[key] = {}
            bindings[key] = [{"HostIp": hp[1],
                              "HostPort": str(hp[0])}]
        return exposed, bindings

    # -- lifecycle -----------------------------------------------------
    def start_task(self, task_name: str, config: dict, env: dict,
                   ctx: Optional[dict] = None) -> TaskHandle:
        if not self.available():
            raise RuntimeError("dockerd is not reachable")
        ctx = ctx or {}
        image = self.api.normalize_image(config["image"])
        if config.get("force_pull") or not self.api.image_exists(image):
            self.api.pull(image)
        resources = ctx.get("resources") or {}
        alloc_id = ctx.get("alloc_id", "anon")
        alloc_networks = ctx.get("alloc_networks") or []
        # network modes (drivers/docker/network.go): bridge (default)
        # gets the label->container port bindings; host and
        # container:<name> share another namespace's stack, where
        # Docker rejects port bindings — ports ride the joined
        # namespace instead
        net_mode = (config.get("network_mode") or "").strip()
        shares_netns = net_mode == "host" or \
            net_mode.startswith("container:")
        if shares_netns:
            exposed, bindings = {}, {}
        else:
            exposed, bindings = self._port_bindings(
                config.get("port_map") or {}, alloc_networks)
        # volumes: jobspec "host:container[:ro]" specs plus the group's
        # volume_mount stanzas resolved by the alloc runner (CSI publish
        # targets / host volumes) — drivers/docker volumes + mounts
        binds = [str(v) for v in (config.get("volumes") or [])]
        for vm in (ctx.get("volume_mounts") or []):
            mode = ":ro" if vm.get("read_only") else ""
            binds.append(f"{vm['source']}:{vm['destination']}{mode}")
        spec = {
            "Image": image,
            "Env": [f"{k}={v}" for k, v in (env or {}).items()],
            "Labels": {LABEL_ALLOC: alloc_id, LABEL_TASK: task_name,
                       **(config.get("labels") or {})},
            "ExposedPorts": exposed,
            "HostConfig": {
                "Memory": int(resources.get("memory_mb", 0)) * 1024 * 1024,
                "CPUShares": int(resources.get("cpu", 0)),
                "PortBindings": bindings,
                "Binds": binds,
            },
        }
        if config.get("command"):
            spec["Cmd"] = [config["command"]] + \
                list(config.get("args") or [])
        if net_mode:
            spec["HostConfig"]["NetworkMode"] = net_mode
        cname = f"nomad-{alloc_id[:8]}-{task_name}-{int(time.time())}"
        cid = self.api.create_container(cname, spec)
        try:
            self.api.start(cid)
        except DockerAPIError:
            try:
                self.api.remove(cid)
            except Exception:
                pass
            raise
        h = TaskHandle(task_name=task_name, driver=self.name,
                       config=config, started_at=time.time())
        h.container_id = cid

        log_dir = ctx.get("log_dir")
        docklog_ok = False
        if log_dir:
            # external docklog process (drivers/docker/docklog): log
            # streaming keeps running across client/driver restarts
            try:
                h.docklog_pid = self._spawn_docklog(
                    cid, task_name, log_dir, ctx)
                h.log_dir = log_dir
                h.log_max_files = int(ctx.get("log_max_files", 10))
                h.log_max_file_size_mb = int(
                    ctx.get("log_max_file_size_mb", 10))
                docklog_ok = True
            except Exception:
                LOG.exception("docklog spawn for %s failed; falling "
                              "back to exit-time collection", cid[:12])

        def wait():
            code = self._wait_resilient(h.container_id)
            if log_dir and not docklog_ok:
                try:
                    self._collect_logs(h.container_id, task_name, log_dir,
                                       ctx)
                except Exception:
                    LOG.debug("log collection for %s failed",
                              h.container_id[:12])
            h.exit_code = code
            h.finished_at = time.time()
            h._done.set()

        threading.Thread(target=wait, daemon=True,
                         name=f"docker-wait-{cid[:12]}").start()
        return h

    def _spawn_docklog(self, cid: str, task_name: str, log_dir: str,
                       ctx: dict, since: int = 0) -> int:
        """Launch the detached docklog streamer (docklog.go analog).
        Returns its pid; the process exits on its own when the
        container stops."""
        import json as _json
        import subprocess
        import sys as _sys

        from .drivers import child_process_env
        spec = {"socket_path": self.api.socket_path,
                "container_id": cid,
                "task_name": task_name,
                "log_dir": log_dir,
                "log_max_files": int(ctx.get("log_max_files", 10)),
                "log_max_file_size_mb": int(
                    ctx.get("log_max_file_size_mb", 10)),
                "since": since}
        proc = subprocess.Popen(
            [_sys.executable, "-m", "nomad_tpu_torch.client.docklog",
             cid[:12]],
            env=child_process_env(),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, start_new_session=True)
        proc.stdin.write(_json.dumps(spec).encode())
        proc.stdin.close()
        # startup handshake: docklog prints OK once its first follow
        # request succeeded — a docklog that dies during startup must
        # not disable the exit-time collection fallback
        import select as _select
        ready, _w, _x = _select.select([proc.stdout], [], [], 10.0)
        line = proc.stdout.readline() if ready else b""
        if not line.startswith(b"OK"):
            try:
                proc.kill()
                proc.wait(timeout=5)
            except Exception:
                pass
            raise RuntimeError("docklog failed to start streaming")
        # reap + watchdog: a docklog that dies while the container
        # still runs is respawned (resuming from now) so log capture
        # doesn't silently stop mid-task
        def reap_and_respawn():
            proc.wait()
            for _attempt in range(3):
                try:
                    info = self.api.inspect(cid)
                except (DockerAPIError, OSError):
                    return
                if not (info.get("State") or {}).get("Running"):
                    return          # normal end-of-task exit
                LOG.warning("docklog for %s died mid-task; respawning",
                            cid[:12])
                try:
                    self._spawn_docklog(cid, task_name, log_dir, ctx,
                                        since=int(time.time()))
                    return          # the new spawn has its own watchdog
                except Exception:
                    LOG.exception("docklog respawn failed")
                    time.sleep(1.0)

        threading.Thread(target=reap_and_respawn, daemon=True,
                         name=f"docklog-reap-{cid[:12]}").start()
        return proc.pid

    def _collect_logs(self, cid: str, task_name: str, log_dir: str,
                      ctx: dict) -> None:
        from .logmon import RotatingWriter
        out, err = self.api.logs(cid)
        max_files = int(ctx.get("log_max_files", 10))
        max_mb = int(ctx.get("log_max_file_size_mb", 10))
        if out:
            w = RotatingWriter(log_dir, f"{task_name}.stdout",
                               max_files, max_mb)
            w.write(out)
            w.close()
        if err:
            w = RotatingWriter(log_dir, f"{task_name}.stderr",
                               max_files, max_mb)
            w.write(err)
            w.close()

    def _wait_resilient(self, cid: str) -> int:
        """api.wait that survives dockerd hiccups: the wait thread
        must ALWAYS complete the handle, or the task runner blocks in
        RUNNING forever. On persistent failure the container is
        treated as lost (137)."""
        while True:
            try:
                return self.api.wait(cid)
            except (DockerAPIError, OSError) as e:
                try:
                    info = self.api.inspect(cid)
                    state = info.get("State") or {}
                    if not state.get("Running"):
                        return int(state.get("ExitCode", 137))
                except (DockerAPIError, OSError):
                    LOG.warning("container %s unreachable (%s); "
                                "reporting lost", cid[:12], e)
                    return 137
                time.sleep(1.0)

    def stop_task(self, handle: TaskHandle, timeout_s: float = 5.0) -> None:
        cid = getattr(handle, "container_id", None)
        if not cid:
            return
        try:
            self.api.stop(cid, int(timeout_s))
        except (DockerAPIError, OSError):
            try:
                self.api.kill(cid)
            except (DockerAPIError, OSError):
                pass
        handle.wait(timeout_s + 10.0)

    def destroy_task(self, handle: TaskHandle) -> None:
        cid = getattr(handle, "container_id", None)
        if cid:
            try:
                self.api.remove(cid)
            except (DockerAPIError, OSError):
                pass

    def stats(self, handle: TaskHandle) -> Dict[str, float]:
        cid = getattr(handle, "container_id", None)
        if not cid:
            return {}
        try:
            s = self.api.stats(cid)
        except (DockerAPIError, OSError):
            return {}
        mem = (s.get("memory_stats") or {}).get("usage", 0)
        cpu = ((s.get("cpu_stats") or {}).get("cpu_usage") or {}) \
            .get("total_usage", 0)
        return {"memory_bytes": float(mem), "cpu_total_ns": float(cpu)}

    def recover_task(self, state: dict) -> Optional[TaskHandle]:
        """Re-attach to a live container after a client restart
        (RecoverTask, drivers/docker/driver.go)."""
        cid = state.get("container_id")
        if not cid or not self.available():
            return None
        try:
            info = self.api.inspect(cid)
        except (DockerAPIError, OSError):
            return None
        if not (info.get("State") or {}).get("Running"):
            return None
        h = TaskHandle(task_name=state.get("task_name", ""),
                       driver=self.name,
                       config=state.get("config") or {},
                       started_at=float(state.get("started_at")
                                        or time.time()),
                       id=state.get("id", ""))
        h.container_id = cid
        # docklog normally survives the restart (own session); respawn
        # only if it died while the container lives (docklog.go
        # re-launch on recovery)
        dl_pid = state.get("docklog_pid")
        log_dir = state.get("log_dir") or ""
        if dl_pid and log_dir:
            log_ctx = {"log_max_files": state.get("log_max_files", 10),
                       "log_max_file_size_mb":
                           state.get("log_max_file_size_mb", 10)}
            if _pid_is_docklog(dl_pid, cid):
                h.docklog_pid = dl_pid
                h.log_dir = log_dir
            else:
                try:
                    h.docklog_pid = self._spawn_docklog(
                        cid, state.get("task_name", "task"), log_dir,
                        log_ctx, since=int(time.time()))
                    h.log_dir = log_dir
                except Exception:
                    LOG.exception("docklog respawn for %s failed",
                                  cid[:12])

        def wait():
            h.exit_code = self._wait_resilient(cid)
            h.finished_at = time.time()
            h._done.set()

        threading.Thread(target=wait, daemon=True).start()
        return h

    # -- orphan reconciler (drivers/docker/reconciler.go) --------------
    def reconcile_orphans(self, live_alloc_ids) -> List[str]:
        """Stop+remove nomad-labeled containers whose alloc this agent
        no longer tracks. Returns removed container ids."""
        if not self.available():
            return []
        removed = []
        try:
            containers = self.api.list_containers(label=LABEL_ALLOC)
        except (DockerAPIError, OSError):
            return []
        live = set(live_alloc_ids)
        for c in containers:
            labels = c.get("Labels") or {}
            aid = labels.get(LABEL_ALLOC)
            if aid and aid not in live:
                cid = c.get("Id")
                try:
                    LOG.warning("reconciler: removing orphan container "
                                "%s (alloc %s)", cid[:12], aid[:8])
                    self.api.remove(cid, force=True)
                    removed.append(cid)
                except DockerAPIError:
                    pass
        return removed

    def start_reconciler(self, live_alloc_ids_fn,
                         interval_s: float = 30.0) -> None:
        """Periodic orphan sweep bound to the owning client's live
        alloc view."""
        def loop():
            while not self._reconcile_stop.wait(interval_s):
                try:
                    self.reconcile_orphans(live_alloc_ids_fn())
                except Exception:
                    LOG.exception("docker reconcile failed")
        self._reconciler = threading.Thread(target=loop, daemon=True,
                                            name="docker-reconciler")
        self._reconciler.start()

    def shutdown(self) -> None:
        self._reconcile_stop.set()
