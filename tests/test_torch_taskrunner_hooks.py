"""The reference's taskrunner_hooks suite (tests/test_taskrunner_hooks.py) against the port's
client/taskenv.py, allocdir.py, hooks.py and logmon.py, servers on the CPU (device="cpu"), assertions unchanged.

The reference's docstring:

Task-runner depth: env interpolation, alloc dirs, artifacts,
templates, log rotation (reference: client/taskenv, client/allocdir,
taskrunner artifact_hook/template_hook, client/logmon).
"""

import os
import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.server import Server as _Server
from nomad_tpu_torch import mock
from nomad_tpu_torch.client.allocdir import AllocDir
from nomad_tpu_torch.client.hooks import (HookError, fetch_artifacts,
                                    render_templates)
from nomad_tpu_torch.client.logmon import RotatingWriter
from nomad_tpu_torch.client.taskenv import (build_task_env, interpolate,
                                      interpolate_config)
from nomad_tpu_torch.models import ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED
from nomad_tpu_torch.models.job import TaskArtifact, Template


def Server(config=None, **kw):
    # the port's Server on the CPU: the kernels' plain versions
    return _Server(config, device="cpu", **kw)


def _wait_for(pred, timeout=15.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


# -- taskenv -----------------------------------------------------------
def test_build_task_env_identity_and_limits():
    alloc = mock.alloc()
    task = alloc.job.task_groups[0].tasks[0]
    node = mock.node()
    env = build_task_env(alloc, task, node, alloc_dir="/a", task_dir="/t",
                         secrets_dir="/s")
    assert env["NOMAD_ALLOC_ID"] == alloc.id
    assert env["NOMAD_TASK_NAME"] == task.name
    assert env["NOMAD_JOB_ID"] == alloc.job.id
    assert env["NOMAD_DC"] == "dc1"
    assert env["NOMAD_CPU_LIMIT"] == str(task.resources.cpu)
    assert env["NOMAD_MEMORY_LIMIT"] == str(task.resources.memory_mb)
    assert env["NOMAD_ALLOC_DIR"] == "/a"
    assert env["NOMAD_TASK_DIR"] == "/t"
    assert env["NOMAD_SECRETS_DIR"] == "/s"


def test_build_task_env_ports_and_meta():
    alloc = mock.alloc()
    task = alloc.job.task_groups[0].tasks[0]
    alloc.job.meta = {"owner": "team-a"}
    task.meta = {"shard": "7"}
    env = build_task_env(alloc, task, mock.node())
    # mock alloc reserves port label "admin" and a dynamic "http"
    port_keys = [k for k in env if k.startswith("NOMAD_PORT_")]
    assert port_keys, env
    for k in port_keys:
        ip_key = k.replace("PORT", "IP")
        addr_key = k.replace("PORT", "ADDR")
        assert env[ip_key]
        assert env[addr_key] == f"{env[ip_key]}:{env[k]}"
    assert env["NOMAD_META_owner"] == "team-a"
    assert env["NOMAD_META_OWNER"] == "team-a"
    assert env["NOMAD_META_shard"] == "7"


def test_interpolation_selectors():
    node = mock.node()
    env = {"NOMAD_TASK_NAME": "web", "FOO": "bar"}
    assert interpolate("${node.datacenter}", env, node) == "dc1"
    assert interpolate("${attr.kernel.name}", env, node) == "linux"
    assert interpolate("${meta.database}", env, node) == "mysql"
    assert interpolate("x-${env.FOO}-${NOMAD_TASK_NAME}", env, node) == \
        "x-bar-web"
    # unknown keys are left intact (env.go keeps unreplaceable vars)
    assert interpolate("${mystery.key}", env, node) == "${mystery.key}"
    cfg = interpolate_config(
        {"cmd": "run-${env.FOO}", "args": ["${node.datacenter}"],
         "n": 3}, env, node)
    assert cfg == {"cmd": "run-bar", "args": ["dc1"], "n": 3}


# -- allocdir ----------------------------------------------------------
def test_allocdir_tree(tmp_path):
    d = AllocDir(str(tmp_path), "alloc-1")
    d.build(["web", "db"])
    td, local, secrets = d.task_paths("web")
    assert os.path.isdir(local)
    assert os.path.isdir(secrets)
    assert os.stat(secrets).st_mode & 0o077 == 0
    assert os.path.isdir(d.logs)
    d.destroy()
    assert not os.path.exists(d.base)


# -- hooks -------------------------------------------------------------
def test_artifact_fetch_local_file(tmp_path):
    src = tmp_path / "payload.bin"
    src.write_bytes(b"hello")
    d = AllocDir(str(tmp_path / "allocs"), "a1")
    d.build(["web"])
    task = mock.job().task_groups[0].tasks[0]
    task.artifacts = [TaskArtifact(getter_source=f"file://{src}")]
    td, local, _ = d.task_paths("web")
    fetch_artifacts(task, td, {}, None)
    assert (tmp_path / "allocs" / "a1" / "web" / "local" /
            "payload.bin").read_bytes() == b"hello"
    # missing source raises a hook error
    task.artifacts = [TaskArtifact(getter_source="/no/such/file")]
    with pytest.raises(HookError):
        fetch_artifacts(task, td, {}, None)


def test_template_render(tmp_path):
    d = AllocDir(str(tmp_path), "a2")
    d.build(["web"])
    task = mock.job().task_groups[0].tasks[0]
    task.templates = [Template(
        embedded_tmpl="addr=${NOMAD_ADDR_web_http} dc=${node.datacenter}",
        dest_path="local/app.conf")]
    td, _, _ = d.task_paths("web")
    env = {"NOMAD_ADDR_web_http": "10.0.0.1:8080"}
    render_templates(task, td, env, mock.node())
    out = (tmp_path / "a2" / "web" / "local" / "app.conf").read_text()
    assert out == "addr=10.0.0.1:8080 dc=dc1"


# -- logmon ------------------------------------------------------------
def test_rotating_writer(tmp_path):
    w = RotatingWriter(str(tmp_path), "web.stdout", max_files=2,
                       max_file_size_mb=1)
    w.max_bytes = 100              # shrink for the test
    for _ in range(7):
        w.write(b"x" * 40)
    w.close()
    files = sorted(os.listdir(tmp_path))
    # 7*40=280 bytes -> rotated past .0; only the last 2 files remain
    assert len(files) == 2, files
    assert files[-1].startswith("web.stdout.")


# -- end to end through a cluster --------------------------------------
@pytest.mark.slow
def test_raw_exec_task_env_artifacts_logs(tmp_path):
    """A raw_exec task sees NOMAD_* env, its fetched artifact, and its
    output lands in rotated log files under the alloc dir."""
    from nomad_tpu_torch.client import Client, ClientConfig
    from nomad_tpu_torch.server import ServerConfig

    art = tmp_path / "art.txt"
    art.write_text("artifact-content")
    alloc_base = tmp_path / "allocs"

    server = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=30.0))
    server.start()
    client = Client(server, ClientConfig(node_name="hooks-client",
                                         alloc_dir=str(alloc_base)))
    client.start()
    try:
        job = mock.batch_job()
        job.task_groups[0].count = 1
        task = job.task_groups[0].tasks[0]
        task.driver = "raw_exec"
        task.config = {
            "command": "/bin/sh",
            "args": ["-c",
                     "echo task=$NOMAD_TASK_NAME alloc=$NOMAD_ALLOC_ID; "
                     "cat local/art.txt"],
        }
        task.artifacts = [TaskArtifact(getter_source=f"file://{art}")]
        server.register_job(job)
        assert _wait_for(lambda: all(
            a.client_status == ALLOC_CLIENT_COMPLETE
            for a in server.store.allocs_by_job("default", job.id))
            and server.store.allocs_by_job("default", job.id)), \
            [(a.client_status, a.task_states)
             for a in server.store.allocs_by_job("default", job.id)]
        alloc = server.store.allocs_by_job("default", job.id)[0]
        log = (alloc_base / alloc.id / "alloc" / "logs" /
               f"{task.name}.stdout.0")
        assert _wait_for(lambda: log.exists() and log.read_bytes())
        content = log.read_text()
        assert f"task={task.name}" in content
        assert f"alloc={alloc.id}" in content
        assert "artifact-content" in content
    finally:
        client.shutdown()
        server.shutdown()


@pytest.mark.slow
def test_artifact_failure_fails_task(tmp_path):
    from nomad_tpu_torch.client import Client, ClientConfig
    from nomad_tpu_torch.server import ServerConfig
    server = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=30.0))
    server.start()
    client = Client(server, ClientConfig(
        node_name="fail-client", alloc_dir=str(tmp_path / "allocs")))
    client.start()
    try:
        job = mock.batch_job()
        job.task_groups[0].count = 1
        task = job.task_groups[0].tasks[0]
        task.config = {"run_for": "10ms"}
        task.artifacts = [TaskArtifact(getter_source="/definitely/missing")]
        server.register_job(job)
        assert _wait_for(lambda: any(
            a.client_status == ALLOC_CLIENT_FAILED
            for a in server.store.allocs_by_job("default", job.id)))
        alloc = server.store.allocs_by_job("default", job.id)[0]
        events = [e.type for ts in alloc.task_states.values()
                  for e in ts.events]
        assert "Setup Failure" in events, events
    finally:
        client.shutdown()
        server.shutdown()


@pytest.mark.slow
def test_fs_and_logs_http_endpoints(tmp_path):
    """/v1/client/fs/{logs,ls,cat} serve a co-located alloc's files
    (client/fs_endpoint.go analog)."""
    from nomad_tpu_torch.api import HTTPApiServer
    from nomad_tpu_torch.api.client import ApiClient
    from nomad_tpu_torch.client import Client, ClientConfig
    from nomad_tpu_torch.server import ServerConfig

    alloc_base = tmp_path / "allocs"
    server = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=30.0))
    server.start()
    client = Client(server, ClientConfig(node_name="fs-client",
                                         alloc_dir=str(alloc_base)))
    client.start()
    api = HTTPApiServer(server, port=0,
                        alloc_dir_bases=[str(alloc_base)])
    api.start()
    try:
        job = mock.batch_job()
        job.task_groups[0].count = 1
        task = job.task_groups[0].tasks[0]
        task.driver = "raw_exec"
        task.config = {"command": "/bin/sh",
                       "args": ["-c", "echo log-line-abc"]}
        server.register_job(job)
        assert _wait_for(lambda: all(
            a.client_status == ALLOC_CLIENT_COMPLETE
            for a in server.store.allocs_by_job("default", job.id))
            and server.store.allocs_by_job("default", job.id))
        alloc = server.store.allocs_by_job("default", job.id)[0]

        c = ApiClient(f"http://127.0.0.1:{api.port}")
        out = {}
        assert _wait_for(lambda: "log-line-abc" in (out.update(
            d=c._request("GET", f"/v1/client/fs/logs/{alloc.id}",
                         params={"task": task.name})) or out["d"]["Data"]))
        # prefix lookup + default task resolution
        short = c._request("GET", f"/v1/client/fs/logs/{alloc.id[:8]}")
        assert "log-line-abc" in short["Data"]
        # ls + cat + escape protection
        ls = c._request("GET", f"/v1/client/fs/ls/{alloc.id}",
                        params={"path": "/alloc/logs"})
        names = [e["Name"] for e in ls]
        assert f"{task.name}.stdout.0" in names
        cat = c._request("GET", f"/v1/client/fs/cat/{alloc.id}",
                         params={"path":
                                 f"/alloc/logs/{task.name}.stdout.0"})
        assert "log-line-abc" in cat["Data"]
        from nomad_tpu_torch.api.client import ApiError
        with pytest.raises(ApiError):
            c._request("GET", f"/v1/client/fs/cat/{alloc.id}",
                       params={"path": "/../../../etc/passwd"})
    finally:
        api.shutdown()
        client.shutdown()
        server.shutdown()


def test_fs_endpoint_namespace_isolation(tmp_path):
    """An alloc is only addressable through its own namespace
    (review: cross-namespace fs bypass)."""
    from nomad_tpu_torch.api import HTTPApiServer
    from nomad_tpu_torch.api.client import ApiClient, ApiError
    from nomad_tpu_torch.server import ServerConfig

    server = Server(ServerConfig(num_schedulers=0))
    api = HTTPApiServer(server, port=0,
                        alloc_dir_bases=[str(tmp_path)])
    api.start()
    try:
        a = mock.alloc()
        a.namespace = "secret"
        server.store.upsert_allocs(1, [a])
        os.makedirs(tmp_path / a.id / "alloc" / "logs", exist_ok=True)
        c = ApiClient(f"http://127.0.0.1:{api.port}")
        # default-namespace request must not resolve the secret alloc
        with pytest.raises(ApiError) as e:
            c._request("GET", f"/v1/client/fs/ls/{a.id}",
                       params={"path": "/"})
        assert e.value.status == 404
        # through its own namespace it resolves
        out = c._request("GET", f"/v1/client/fs/ls/{a.id}",
                         params={"path": "/", "namespace": "secret"})
        assert isinstance(out, list)
    finally:
        api.shutdown()
        server.shutdown()
