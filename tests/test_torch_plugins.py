"""The reference's plugins suite (tests/test_plugins.py) against the port's
plugins/ (the driver plugin boundary), servers on the CPU (device="cpu"), assertions unchanged.

The reference's docstring:

Driver plugin process boundary (reference: go-plugin handshake
plugins/base/plugin.go:26-35, DriverPlugin interface
plugins/drivers/driver.go, drivermanager supervision).
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.server import Server as _Server
from nomad_tpu_torch import mock
from nomad_tpu_torch.models import ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_RUNNING
from nomad_tpu_torch.plugins import ExternalDriver
from nomad_tpu_torch.plugins.base import HANDSHAKE_COOKIE_KEY


REPO = Path(__file__).resolve().parent.parent


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


@pytest.fixture
def mock_plugin():
    d = ExternalDriver("mock_driver")
    yield d
    d.shutdown()


def test_plugin_refuses_bare_launch():
    env = {k: v for k, v in os.environ.items()
           if k != HANDSHAKE_COOKIE_KEY}
    out = subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch.plugins.launcher",
         "mock_driver"],
        env=env, cwd=REPO, capture_output=True, text=True,
        timeout=30)
    assert out.returncode == 1
    assert "plugin" in out.stderr


def test_plugin_lifecycle_start_wait_stop(mock_plugin):
    d = mock_plugin
    assert d.fingerprint()["driver.mock_driver"] == "1"
    h = d.start_task("t1", {"run_for": "100ms", "exit_code": 0}, {})
    assert h.wait(5.0)
    assert h.exit_code == 0
    # failure exit codes propagate
    h2 = d.start_task("t2", {"run_for": "50ms", "exit_code": 3}, {})
    assert h2.wait(5.0) and h2.exit_code == 3
    # start errors raise like in-proc drivers
    with pytest.raises(RuntimeError):
        d.start_task("t3", {"start_error": "boom"}, {})
    # stop kills a long task
    h4 = d.start_task("t4", {"run_for": "60s"}, {})
    d.stop_task(h4, 2.0)
    assert h4.wait(2.0) and h4.exit_code == 137


def test_plugin_recover_task(mock_plugin):
    d = mock_plugin
    h = d.start_task("t", {"run_for": "10s"}, {})
    state = h.recoverable_state()
    h2 = d.recover_task(state)
    assert h2 is not None and not h2.done()
    d.stop_task(h2, 2.0)


def test_plugin_crash_relaunch(mock_plugin):
    d = mock_plugin
    h = d.start_task("t", {"run_for": "60s"}, {})
    # kill the plugin process: the in-flight wait reports task lost
    d._proc.kill()
    assert h.wait(10.0)
    assert h.exit_code == 137
    # the supervisor relaunches on next use
    h2 = d.start_task("t2", {"run_for": "50ms"}, {})
    assert h2.wait(5.0) and h2.exit_code == 0


@pytest.mark.slow
def test_cluster_runs_job_via_plugin_driver():
    from nomad_tpu_torch.client import Client, ClientConfig
    from nomad_tpu_torch.server import ServerConfig
    server = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=30.0))
    server.start()
    client = Client(server, ClientConfig(
        node_name="plugin-client", plugin_drivers=("mock_driver",)))
    client.start()
    try:
        job = mock.batch_job()
        job.task_groups[0].count = 2
        job.task_groups[0].tasks[0].config = {"run_for": "100ms"}
        server.register_job(job)
        assert _wait_for(lambda: len(
            server.store.allocs_by_job("default", job.id)) == 2)
        assert _wait_for(lambda: all(
            a.client_status == ALLOC_CLIENT_COMPLETE
            for a in server.store.allocs_by_job("default", job.id))), \
            [a.client_status
             for a in server.store.allocs_by_job("default", job.id)]
    finally:
        client.shutdown()
        server.shutdown()
