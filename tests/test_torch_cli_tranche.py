"""The reference's CLI tranche tests (tests/test_cli_tranche.py) against
the port's cli/ and api/, the server on the CPU, their assertions
unchanged, test_node_drain_monitor with the port's Client.
test_operator_debug_archive's bundle carries the port's telemetry ring,
and the newest chaos artifact of the working directory as chaos.json
(the test runs in a directory holding a CHAOS_r01.json).

The reference's docstring:

CLI tranche: version/ui/status/volume/operator-snapshot/autopilot/
job-promote (vs command/status.go, command/volume_*.go,
command/operator_snapshot_*.go, command/operator_autopilot_*.go)."""

import contextlib
import io
import json

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.api import HTTPApiServer
from nomad_tpu_torch.cli.main import main as cli
from nomad_tpu_torch.models.csi import CSIVolume
from nomad_tpu_torch.server import Server, ServerConfig

import test_torch_select  # noqa: F401  (torch's thread cap)


@pytest.fixture
def cluster():
    srv = Server(ServerConfig(num_schedulers=0), device="cpu")
    srv.start()
    api = HTTPApiServer(srv, port=0)
    api.start()
    job = mock.batch_job()
    job.id = "smoke-job"
    srv.register_job(job)
    yield srv, f"http://127.0.0.1:{api.port}"
    api.shutdown()
    srv.shutdown()


def run(addr, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(["-address", addr, *argv])
    return rc, out.getvalue()


def test_version_and_ui(cluster):
    _s, addr = cluster
    rc, out = run(addr, "version")
    assert rc in (0, None) and "nomad-tpu v" in out
    _rc, out = run(addr, "ui")
    assert "/ui" in out


def test_status_lookup(cluster):
    _s, addr = cluster
    _rc, out = run(addr, "status")
    assert "smoke-job" in out
    _rc, out = run(addr, "status", "smoke")
    assert "jobs" in out and "smoke" in out
    rc, _out = run(addr, "status", "zzz-no-such")
    assert rc == 1


def test_autopilot_config_roundtrip(cluster):
    srv, addr = cluster
    _rc, out = run(addr, "operator", "autopilot-get-config")
    assert "CleanupDeadServers" in out
    run(addr, "operator", "autopilot-set-config",
        "-dead-server-cleanup-secs", "60")
    assert srv.config.dead_server_cleanup_s == 60.0


def test_volume_commands(cluster, tmp_path):
    srv, addr = cluster
    srv.register_csi_volume(CSIVolume(id="vol1", plugin_id="plug",
                                      namespace="default"))
    _rc, out = run(addr, "volume", "status")
    assert "vol1" in out
    _rc, out = run(addr, "volume", "status", "vol1")
    assert "plug" in out
    # register from a JSON spec file
    spec = tmp_path / "vol.json"
    spec.write_text(json.dumps(
        {"id": "vol2", "plugin_id": "plug", "namespace": "default"}))
    _rc, out = run(addr, "volume", "register", str(spec))
    assert "registered" in out
    assert srv.store.csi_volume("default", "vol2") is not None
    _rc, out = run(addr, "volume", "deregister", "vol1")
    assert "deregistered" in out
    assert srv.store.csi_volume("default", "vol1") is None


def test_snapshot_save_inspect_restore(cluster, tmp_path):
    """operator snapshot round-trip brings a purged job back (dev
    mode; clustered restore is refused — raft reseeds followers)."""
    srv, addr = cluster
    snap = tmp_path / "snap.json"
    _rc, out = run(addr, "operator", "snapshot-save", str(snap))
    assert "written" in out
    _rc, out = run(addr, "operator", "snapshot-inspect", str(snap))
    assert "jobs" in out
    srv.deregister_job("default", "smoke-job", purge=True)
    assert srv.store.job_by_id("default", "smoke-job") is None
    _rc, out = run(addr, "operator", "snapshot-restore", str(snap))
    assert "restored" in out
    assert srv.store.job_by_id("default", "smoke-job") is not None




def test_job_run_check_index(cluster, tmp_path):
    """job run -check-index is a CAS submit (job_endpoint.go
    EnforceIndex): stale indexes are rejected, the current one wins,
    and 0 means the job must not exist."""
    _s, addr = cluster
    jobfile = tmp_path / "cas.nomad"
    rc, _ = run(addr, "job", "init", str(jobfile))
    assert rc == 0

    # 0 = must not exist: first submit succeeds
    rc, out = run(addr, "job", "run", "-detach", "-check-index", "0",
                  str(jobfile))
    assert rc == 0, out
    # 0 again: now it exists -> rejected
    rc, out = run(addr, "job", "run", "-detach", "-check-index", "0",
                  str(jobfile))
    assert rc != 0
    # wrong index -> rejected with the current index in the error
    rc, out = run(addr, "job", "run", "-detach", "-check-index",
                  "999999", str(jobfile))
    assert rc != 0
    # the real index -> accepted
    import urllib.request
    data = json.load(urllib.request.urlopen(f"{addr}/v1/job/example"))
    cur = data["job_modify_index"]
    rc, out = run(addr, "job", "run", "-detach", "-check-index",
                  str(cur), str(jobfile))
    assert rc == 0, out


def test_node_drain_monitor(tmp_path):
    """node drain -monitor blocks until the node is drained
    (command/node_drain.go -monitor)."""
    from nomad_tpu_torch.client import Client, ClientConfig
    srv = Server(ServerConfig(num_schedulers=1, heartbeat_ttl_s=30.0),
                 device="cpu")
    srv.start()
    api = HTTPApiServer(srv, port=0)
    api.start()
    client = Client(srv, ClientConfig(node_name="drainme",
                                      alloc_dir=str(tmp_path)))
    client.start()
    addr = f"http://127.0.0.1:{api.port}"
    try:
        job = mock.batch_job()
        job.id = "drain-job"
        job.type = "service"
        tg = job.task_groups[0]
        tg.count = 1
        tg.tasks[0].config = {"run_for": "60s"}
        job.canonicalize()
        srv.register_job(job)
        import time as _t
        deadline = _t.time() + 20
        while _t.time() < deadline and not any(
                a.client_status == "running"
                for a in srv.store.allocs_by_job("default", job.id)):
            _t.sleep(0.1)
        rc, out = run(addr, "node", "drain", client.node.id, "-enable",
                      "-monitor")
        assert rc == 0, out
        assert "Drain complete" in out or "drain strategy cleared" in out
    finally:
        client.shutdown()
        api.shutdown()
        srv.shutdown()


def test_operator_debug_archive(cluster, tmp_path, monkeypatch):
    """operator debug bundles cluster state + interval metrics + pprof
    into a tar.gz (command/operator_debug.go), and the working
    directory's newest CHAOS_rNN.json as chaos.json."""
    import tarfile
    _s, addr = cluster
    workdir = tmp_path / "work"
    workdir.mkdir()
    artifact = {"schema": "nomad-tpu/chaos/1", "cells": [],
                "summary": {"cells": 0, "passed": 0}}
    (workdir / "CHAOS_r01.json").write_text(json.dumps(artifact))
    monkeypatch.chdir(workdir)
    # the fixture's idle num_schedulers=0 server may not have emitted
    # any metric yet (the stats ticker runs on a 1s cadence): seed one
    # so the bundle's metrics.prom assertion below is deterministic
    from nomad_tpu_torch.utils import metrics as gm
    gm.set_gauge("nomad.test.debug_probe", 1.0)
    out_path = str(tmp_path / "debug.tar.gz")
    rc, out = run(addr, "operator", "debug", "-duration", "1",
                  "-interval", "0.5", "-output", out_path)
    assert rc == 0, out
    assert "Created debug archive" in out
    with tarfile.open(out_path) as tar:
        names = tar.getnames()
        base = names[0].split("/")[0]
        expect = ["agent-self.json", "members.json", "raft-status.json",
                  "nomad/jobs.json", "nomad/nodes.json",
                  "pprof/threads.json", "index.json",
                  "metrics/metrics_000.json", "metrics/metrics_001.json",
                  # retained telemetry: the history ring,
                  # the live flatness verdict, and a Prometheus-format
                  # snapshot ride in the bundle one-shot
                  "telemetry.json", "flatness.json", "metrics.prom"]
        for n in expect:
            assert f"{base}/{n}" in names, (n, names)
        idx = json.load(tar.extractfile(f"{base}/index.json"))
        assert idx["captures"] >= len(expect)
        jobs = json.load(tar.extractfile(f"{base}/nomad/jobs.json"))
        assert any(j["ID"] == "smoke-job" for j in jobs)
        tel = json.load(tar.extractfile(f"{base}/telemetry.json"))
        assert tel.get("slots", 0) > 0 and "series" in tel
        prom = tar.extractfile(f"{base}/metrics.prom").read().decode()
        assert "# TYPE" in prom
        assert json.load(tar.extractfile(f"{base}/chaos.json")) == \
            artifact
