"""The reference's hclspec and device-plugin suite
(tests/test_hclspec_devices.py: hclspec-typed plugin config + the
out-of-proc device plugin boundary; reference:
plugins/shared/hclspec/hcl_spec.proto, plugins/device/device.go) against
the port's plugins/ and client/ on the CPU.

Its assertions unchanged but one departure of the port: the device
plugin's reservation scopes a task to its cards by CUDA_VISIBLE_DEVICES,
the instances' indices ("gpu-0" -> "0"), where the JAX package's sets
JAX_VISIBLE_DEVICES to the instance ids; the two reservation checks ask
for the port's variable."""

import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.server import Server as _Server
from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.plugins.hclspec import (Attr, Block, SpecError, decode,
                                       describe, spec_from_wire)
from nomad_tpu_torch.server import ServerConfig


# -- hclspec decode ----------------------------------------------------

SPEC = {
    "command": Attr("string", required=True),
    "args": Attr("list(string)", default=[]),
    "priority": Attr("number", default=50),
    "privileged": Attr("bool", default=False),
    "auth": Block({"username": Attr("string", required=True),
                   "password": Attr("string")}),
}


def Server(config=None, **kw):
    # the port's Server on the CPU: the kernels' plain versions
    return _Server(config, device="cpu", **kw)


def test_decode_applies_defaults_and_coerces():
    out = decode(SPEC, {"command": "echo", "priority": "80",
                        "privileged": "true"})
    assert out == {"command": "echo", "args": [], "priority": 80,
                   "privileged": True}


def test_decode_rejects_unknown_keys_and_missing_required():
    with pytest.raises(SpecError, match="unknown keys: comand"):
        decode(SPEC, {"command": "x", "comand": "typo"})
    with pytest.raises(SpecError, match="command: required"):
        decode(SPEC, {})
    with pytest.raises(SpecError, match="expected list"):
        decode(SPEC, {"command": "x", "args": "not-a-list"})


def test_decode_nested_blocks():
    out = decode(SPEC, {"command": "x",
                        "auth": {"username": "u"}})
    assert out["auth"] == {"username": "u"}
    with pytest.raises(SpecError, match="auth.username: required"):
        decode(SPEC, {"command": "x", "auth": {}})


def test_spec_round_trips_over_the_wire():
    wire = describe(SPEC)
    back = spec_from_wire(wire)
    assert decode(back, {"command": "x"}) == decode(SPEC, {"command": "x"})


# -- driver config validation at prestart ------------------------------

def _wait(pred, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_bad_driver_config_fails_task_with_spec_error():
    s = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=60.0))
    s.start()
    c = Client(s, ClientConfig(node_name="spec-client"))
    c.start()
    try:
        job = mock.batch_job()
        job.id = "typo-job"
        tg = job.task_groups[0]
        tg.count = 1
        tg.tasks[0].config = {"run_for": "10s", "exit_kode": 1}  # typo
        tg.tasks[0].resources.networks = []
        tg.networks = []
        s.register_job(job)
        assert _wait(lambda: any(
            a.client_status == "failed"
            for a in s.store.allocs_by_job("default", "typo-job")))
        alloc = s.store.allocs_by_job("default", "typo-job")[0]
        states = alloc.task_states or {}
        msgs = " ".join(
            f"{ev.type} {ev.message} {ev.display_message}"
            for st in states.values() for ev in (st.events or []))
        assert "unknown keys: exit_kode" in msgs, msgs
    finally:
        c.shutdown()
        s.shutdown()


# -- out-of-proc device plugin ----------------------------------------

def test_external_device_plugin_process_boundary():
    from nomad_tpu_torch.plugins.device_client import ExternalDevicePlugin
    p = ExternalDevicePlugin("accelerator")
    try:
        groups = p.fingerprint()        # may be [] on CPU-only hosts
        assert isinstance(groups, list)
        r = p.reserve(["gpu-0", "gpu-1"])
        assert r["envs"]["CUDA_VISIBLE_DEVICES"] == "0,1"
        stats = p.stats()
        assert isinstance(stats, list)
        # the plugin survives being called again (process reused)
        assert isinstance(p.fingerprint(), list)
    finally:
        p.shutdown()


def test_device_plugin_relaunches_after_crash():
    from nomad_tpu_torch.plugins.device_client import ExternalDevicePlugin
    p = ExternalDevicePlugin("accelerator")
    try:
        p.reserve(["gpu-0"])
        p._proc.kill()
        p._proc.wait()
        r = p.reserve(["gpu-1"])        # supervised relaunch
        assert r["envs"]["CUDA_VISIBLE_DEVICES"] == "1"
    finally:
        p.shutdown()
