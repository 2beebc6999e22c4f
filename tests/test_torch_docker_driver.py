"""The reference's docker_driver suite (tests/test_docker_driver.py) against the port's
client/docker_driver.py and docklog.py, servers on the CPU (device="cpu"), assertions unchanged.

The reference's docstring:

Docker driver against a FAKE dockerd speaking the Engine API over a
unix socket — full driver-logic coverage (lifecycle, port maps, stats,
logs demux, recover, orphan reconcile) without requiring a real
dockerd; hosts without docker drop the driver cleanly.

Reference scenarios: drivers/docker/driver.go (StartTask pull/create/
start, port_map, stats, RecoverTask), drivers/docker/reconciler.go.
"""

import json
import os
import socket
import socketserver
import struct
import threading
import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.client.docker_driver import (DockerAPI, DockerDriver,
                                            LABEL_ALLOC)


class FakeDockerd:
    """Tiny Engine-API fake over a unix socket: containers are dicts;
    'running' containers exit when .finish() is called."""

    def __init__(self, sock_path):
        self.sock_path = sock_path
        self.containers = {}
        self.images = {"busybox:latest"}
        self.pulls = []
        self._seq = 0
        self._waiters = {}
        fake = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    line = self.rfile.readline().decode()
                    method, path, _ = line.split(" ", 2)
                    length = 0
                    while True:
                        h = self.rfile.readline().decode().strip()
                        if not h:
                            break
                        if h.lower().startswith("content-length:"):
                            length = int(h.split(":")[1])
                    body = json.loads(self.rfile.read(length)) \
                        if length else None
                    if method == "GET" and "/logs" in path and \
                            "follow=1" in path:
                        fake.stream_logs(path, self.wfile)
                        return
                    status, payload = fake.route(method, path, body)
                    if not isinstance(payload, (bytes, bytearray)):
                        payload = json.dumps(payload).encode()
                    self.wfile.write(
                        f"HTTP/1.1 {status} X\r\nContent-Length: "
                        f"{len(payload)}\r\n\r\n".encode() + payload)
                except Exception:
                    pass

        class Srv(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True

        self.srv = Srv(sock_path, Handler)
        threading.Thread(target=self.srv.serve_forever,
                         daemon=True).start()

    def route(self, method, path, body):
        from urllib.parse import parse_qs, unquote, urlparse
        u = urlparse(path)
        q = {k: v[0] for k, v in parse_qs(u.query).items()}
        parts = u.path.strip("/").split("/")
        if u.path == "/version":
            return 200, {"Version": "99.fake"}
        if u.path == "/images/create":
            self.pulls.append(q.get("fromImage"))
            self.images.add(q.get("fromImage"))
            return 200, b""
        if parts[0] == "images" and parts[-1] == "json":
            name = unquote("/".join(parts[1:-1]))
            return (200, {}) if name in self.images \
                else (404, {"message": "no such image"})
        if u.path == "/containers/create":
            self._seq += 1
            cid = f"c{self._seq:06d}" + "0" * 58
            self.containers[cid] = {
                "Id": cid, "Name": q.get("name", ""),
                "Spec": body, "State": {"Running": False},
                "ExitCode": None,
                "Labels": (body or {}).get("Labels") or {},
                "LogBuf": [(1, b"hello out\n"), (2, b"oops\n")],
                "LogCv": threading.Condition()}
            self._waiters[cid] = threading.Event()
            return 201, {"Id": cid}
        if u.path == "/containers/json":
            out = []
            label_filter = None
            if "filters" in q:
                label_filter = json.loads(q["filters"])["label"][0]
            for c in self.containers.values():
                if label_filter and label_filter not in [
                        f"{k}" for k in c["Labels"]] and \
                        label_filter not in c["Labels"]:
                    continue
                out.append({"Id": c["Id"], "Labels": c["Labels"],
                            "State": "running" if c["State"]["Running"]
                            else "exited"})
            return 200, out
        cid = parts[1] if len(parts) > 1 else ""
        c = self.containers.get(cid)
        if c is None:
            return 404, {"message": "no such container"}
        action = parts[2] if len(parts) > 2 else ""
        if method == "POST" and action == "start":
            c["State"]["Running"] = True
            return 204, b""
        if method == "POST" and action in ("stop", "kill"):
            self.finish(cid, 137 if action == "kill" else 0)
            return 204, b""
        if method == "POST" and action == "wait":
            self._waiters[cid].wait(30)
            return 200, {"StatusCode": c["ExitCode"] or 0}
        if method == "GET" and action == "json":
            return 200, {k: v for k, v in c.items()
                         if k not in ("LogBuf", "LogCv")}
        if method == "GET" and action == "stats":
            return 200, {"memory_stats": {"usage": 7 * 1024 * 1024},
                         "cpu_stats": {"cpu_usage":
                                       {"total_usage": 123456789}}}
        if method == "GET" and action == "logs":
            def frame(stream, data):
                return struct.pack(">BxxxL", stream, len(data)) + data
            return 200, b"".join(frame(s, d) for s, d in c["LogBuf"])
        if method == "DELETE":
            self.finish(cid, c["ExitCode"] or 137)
            del self.containers[cid]
            return 204, b""
        return 400, {"message": f"unhandled {method} {u.path}"}

    def emit_log(self, cid, stream, data):
        """Append a log frame; follow-mode readers wake up."""
        c = self.containers[cid]
        with c["LogCv"]:
            c["LogBuf"].append((stream, data))
            c["LogCv"].notify_all()

    def stream_logs(self, path, wfile):
        """follow=1: chunked-ish raw stream of frames until the
        container stops (the docklog transport)."""
        cid = path.strip("/").split("/")[1]
        c = self.containers.get(cid)
        if c is None:
            wfile.write(b"HTTP/1.1 404 X\r\nContent-Length: 2\r\n\r\n{}")
            return
        wfile.write(b"HTTP/1.1 200 X\r\n\r\n")
        wfile.flush()
        sent = 0
        while True:
            with c["LogCv"]:
                while sent >= len(c["LogBuf"]) and c["State"]["Running"]:
                    c["LogCv"].wait(0.2)
                frames = c["LogBuf"][sent:]
                sent = len(c["LogBuf"])
                running = c["State"]["Running"]
            for s, d in frames:
                wfile.write(struct.pack(">BxxxL", s, len(d)) + d)
            wfile.flush()
            if not running and sent >= len(c["LogBuf"]):
                return

    def finish(self, cid, code):
        c = self.containers.get(cid)
        if c is not None and c["ExitCode"] is None:
            c["ExitCode"] = code
            c["State"]["Running"] = False
            with c["LogCv"]:
                c["LogCv"].notify_all()
        ev = self._waiters.get(cid)
        if ev:
            ev.set()

    def close(self):
        self.srv.shutdown()


@pytest.fixture
def dockerd(tmp_path):
    sock = str(tmp_path / "docker.sock")
    fake = FakeDockerd(sock)
    yield fake, sock
    fake.close()


def test_driver_absent_without_dockerd(tmp_path):
    d = DockerDriver(socket_path=str(tmp_path / "nope.sock"))
    assert not d.available()
    assert d.fingerprint() == {}


def test_lifecycle_ports_stats_and_logs(dockerd, tmp_path):
    fake, sock = dockerd
    d = DockerDriver(socket_path=sock)
    assert d.available()
    assert d.fingerprint()["driver.docker.version"] == "99.fake"

    from nomad_tpu_torch.models import NetworkResource, Port
    nw = NetworkResource(ip="10.0.0.5",
                         reserved_ports=[Port(label="http", value=8080)],
                         dynamic_ports=[Port(label="db", value=21000)])
    log_dir = str(tmp_path / "logs")
    os.makedirs(log_dir)
    h = d.start_task(
        "web",
        {"image": "redis:7", "command": "redis-server",
         "args": ["--port", "6379"],
         "port_map": {"http": 80, "db": 5432}},
        {"MYENV": "1"},
        ctx={"alloc_id": "alloc0001", "log_dir": log_dir,
             "resources": {"cpu": 500, "memory_mb": 256},
             "alloc_networks": [nw]})
    assert fake.pulls == ["redis:7"]        # image pulled on demand
    cid = h.container_id
    spec = fake.containers[cid]["Spec"]
    assert spec["Cmd"] == ["redis-server", "--port", "6379"]
    assert "MYENV=1" in spec["Env"]
    assert spec["HostConfig"]["Memory"] == 256 * 1024 * 1024
    assert spec["HostConfig"]["PortBindings"]["80/tcp"] == \
        [{"HostIp": "10.0.0.5", "HostPort": "8080"}]
    assert spec["HostConfig"]["PortBindings"]["5432/tcp"] == \
        [{"HostIp": "10.0.0.5", "HostPort": "21000"}]
    assert fake.containers[cid]["State"]["Running"]

    stats = d.stats(h)
    assert stats["memory_bytes"] == 7 * 1024 * 1024

    # stop -> exit code propagates, logs demuxed into rotated files
    # (docklog streams asynchronously — wait for its flush)
    d.stop_task(h, timeout_s=2.0)
    assert h.wait(10) and h.exit_code == 0

    def _read(name):
        p = os.path.join(log_dir, name)
        return open(p).read() if os.path.exists(p) else ""
    deadline = time.time() + 10
    while time.time() < deadline and (
            _read("web.stdout.0") != "hello out\n"
            or _read("web.stderr.0") != "oops\n"):
        time.sleep(0.1)
    assert _read("web.stdout.0") == "hello out\n"
    assert _read("web.stderr.0") == "oops\n"


def test_recover_reattaches_to_running_container(dockerd):
    fake, sock = dockerd
    d = DockerDriver(socket_path=sock)
    h = d.start_task("svc", {"image": "busybox"}, {},
                     ctx={"alloc_id": "alloc0002",
                          "resources": {"cpu": 100, "memory_mb": 64}})
    assert not fake.pulls                   # image cache hit
    state = h.recoverable_state()
    assert state["container_id"] == h.container_id

    d2 = DockerDriver(socket_path=sock)
    h2 = d2.recover_task(state)
    assert h2 is not None and h2.container_id == h.container_id
    fake.finish(h.container_id, 3)
    assert h2.wait(10) and h2.exit_code == 3

    # a dead container does not re-attach
    assert d2.recover_task(state) is None


def test_orphan_reconciler_removes_unowned_containers(dockerd):
    fake, sock = dockerd
    d = DockerDriver(socket_path=sock)
    h1 = d.start_task("keep", {"image": "busybox"}, {},
                      ctx={"alloc_id": "alive001",
                           "resources": {"cpu": 100, "memory_mb": 64}})
    h2 = d.start_task("orph", {"image": "busybox"}, {},
                      ctx={"alloc_id": "gone0001",
                           "resources": {"cpu": 100, "memory_mb": 64}})
    removed = d.reconcile_orphans({"alive001"})
    assert removed == [h2.container_id]
    assert h1.container_id in fake.containers
    assert h2.container_id not in fake.containers


def test_volume_binds_and_network_modes(dockerd, tmp_path):
    """drivers/docker volumes + network.go modes: jobspec volume specs
    and resolved volume_mounts land in HostConfig.Binds; host and
    container: network modes share a namespace so port bindings are
    omitted; bridge (default) binds the port_map."""
    fake, sock = dockerd
    d = DockerDriver(socket_path=sock)
    h = d.start_task(
        "web", {"image": "busybox:latest",
                "volumes": ["/host/data:/data:ro"],
                "network_mode": "host",
                "port_map": {"http": 8080}},
        {}, ctx={"alloc_id": "dockvol1",
                 "volume_mounts": [{"volume": "v",
                                    "source": str(tmp_path / "csi"),
                                    "destination": "/mnt/vol",
                                    "read_only": False}],
                 "alloc_networks": [
                     {"ip": "10.0.0.1",
                      "reserved_ports": [],
                      "dynamic_ports": [{"label": "http",
                                         "value": 21000}]}],
                 "resources": {"cpu": 100, "memory_mb": 64}})
    spec = fake.containers[h.container_id]["Spec"]
    binds = spec["HostConfig"]["Binds"]
    assert "/host/data:/data:ro" in binds
    assert f"{tmp_path / 'csi'}:/mnt/vol" in binds
    # host networking: no port bindings, mode passed through
    assert spec["HostConfig"]["NetworkMode"] == "host"
    assert spec["HostConfig"]["PortBindings"] == {}
    d.stop_task(h, timeout_s=2.0)
    assert h.wait(10)

    # container:<name> shares another container's namespace
    h2 = d.start_task(
        "side", {"image": "busybox:latest",
                 "network_mode": f"container:{h.container_id}",
                 "port_map": {"http": 9090}},
        {}, ctx={"alloc_id": "dockvol2",
                 "resources": {"cpu": 100, "memory_mb": 64}})
    spec2 = fake.containers[h2.container_id]["Spec"]
    assert spec2["HostConfig"]["NetworkMode"] == \
        f"container:{h.container_id}"
    assert spec2["HostConfig"]["PortBindings"] == {}
    d.stop_task(h2, timeout_s=2.0)

    # bridge (default) keeps the bindings
    h3 = d.start_task(
        "brid", {"image": "busybox:latest",
                 "port_map": {"http": 8080}},
        {}, ctx={"alloc_id": "dockvol3",
                 "alloc_networks": [
                     {"ip": "10.0.0.1",
                      "reserved_ports": [],
                      "dynamic_ports": [{"label": "http",
                                         "value": 21001}]}],
                 "resources": {"cpu": 100, "memory_mb": 64}})
    spec3 = fake.containers[h3.container_id]["Spec"]
    assert spec3["HostConfig"]["PortBindings"] == {
        "8080/tcp": [{"HostIp": "10.0.0.1", "HostPort": "21001"}]}
    d.stop_task(h3, timeout_s=2.0)


def test_docklog_streams_and_survives_driver_restart(dockerd, tmp_path):
    """drivers/docker/docklog: the external streamer keeps writing the
    task's log files after the driver object (client) goes away, and a
    NEW driver's RecoverTask finds it alive and does not respawn."""
    fake, sock = dockerd
    log_dir = tmp_path / "logs"
    log_dir.mkdir()
    d = DockerDriver(socket_path=sock)
    h = d.start_task(
        "logt", {"image": "busybox:latest"},
        {}, ctx={"alloc_id": "docklog1", "log_dir": str(log_dir),
                 "resources": {"cpu": 100, "memory_mb": 64}})
    assert getattr(h, "docklog_pid", None)
    state = h.recoverable_state()
    cid = h.container_id

    def stdout_content():
        out = ""
        for f in os.listdir(log_dir):
            if "stdout" in f:
                out += open(os.path.join(log_dir, f)).read()
        return out

    deadline = time.time() + 10
    while time.time() < deadline and "hello out" not in stdout_content():
        time.sleep(0.1)
    assert "hello out" in stdout_content()

    # the "client restart": drop the driver; the fake keeps emitting
    del d
    fake.emit_log(cid, 1, b"after-restart\n")
    deadline = time.time() + 10
    while time.time() < deadline and \
            "after-restart" not in stdout_content():
        time.sleep(0.1)
    assert "after-restart" in stdout_content(), \
        "docklog must keep streaming with no client attached"

    # a fresh driver recovers and sees docklog alive (same pid)
    d2 = DockerDriver(socket_path=sock)
    h2 = d2.recover_task(state)
    assert h2 is not None
    assert h2.docklog_pid == state["docklog_pid"]
    fake.finish(cid, 0)
    assert h2.wait(15)
    # docklog exits once the container stops
    deadline = time.time() + 10
    while time.time() < deadline and \
            os.path.isdir(f"/proc/{h2.docklog_pid}"):
        time.sleep(0.1)
    assert not os.path.isdir(f"/proc/{h2.docklog_pid}")
