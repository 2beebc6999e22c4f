"""The reference's java_qemu_drivers suite (tests/test_java_qemu_drivers.py) against the port's
client/drivers.py (JavaDriver, QemuDriver), servers on the CPU (device="cpu"), assertions unchanged.

The reference's docstring:

Java + QEMU drivers (drivers/java/driver.go, drivers/qemu/driver.go).

Real binaries are absent in CI, so the tests install stub executables
on PATH that record their argv — the same conditional-driver pattern
the docker tests use. What's asserted is the reference's command-line
construction and lifecycle semantics, not the JVM/VM themselves.
"""

import os
import stat
import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.client.drivers import JavaDriver, QemuDriver


@pytest.fixture
def stub_path(tmp_path, monkeypatch):
    """A bin dir on PATH whose stubs append their argv to argv.log and
    sleep until killed."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "argv.log"

    def install(name, version_output="", version_to_stderr=False):
        dest = "2" if version_to_stderr else "1"
        script = f"""#!/bin/sh
if [ "$1" = "-version" ] || [ "$1" = "--version" ]; then
  printf '%s\\n' '{version_output}' >&{dest}
  exit 0
fi
echo "$0 $@" >> {log}
exec sleep 60
"""
        p = bindir / name
        p.write_text(script)
        p.chmod(p.stat().st_mode | stat.S_IEXEC)

    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    return install, log


def test_java_availability_and_fingerprint(stub_path):
    install, _log = stub_path
    drv = JavaDriver()
    # `java -version` writes to stderr (javaVersionInfo driver.go:239)
    install("java", 'openjdk version "17.0.2"', version_to_stderr=True)
    assert drv.available()
    fp = drv.fingerprint()
    assert fp["driver.java"] == "1"
    assert fp["driver.java.version"] == "17.0.2"


def test_java_requires_jar_or_class(stub_path):
    install, _log = stub_path
    install("java")
    with pytest.raises(RuntimeError, match="jar_path or class"):
        JavaDriver().start_task("t", {}, {})


def test_java_jar_command_line(stub_path, tmp_path):
    install, log = stub_path
    install("java")
    drv = JavaDriver()
    h = drv.start_task("web", {
        "jar_path": "app.jar",
        "jvm_options": ["-Xmx64m"],
        "args": ["serve", "--port=80"],
    }, {}, ctx={"task_dir": str(tmp_path)})
    try:
        deadline = time.time() + 5
        while time.time() < deadline and not log.exists():
            time.sleep(0.05)
        argv = log.read_text().strip()
        assert "-Xmx64m" in argv
        assert f"-jar {tmp_path}/app.jar" in argv
        assert argv.endswith("serve --port=80")
    finally:
        drv.stop_task(h, 2.0)


def test_java_class_command_line(stub_path):
    install, log = stub_path
    install("java")
    drv = JavaDriver()
    h = drv.start_task("web", {
        "class": "com.example.Main",
        "class_path": "/opt/lib",
    }, {})
    try:
        deadline = time.time() + 5
        while time.time() < deadline and not log.exists():
            time.sleep(0.05)
        argv = log.read_text().strip()
        assert "-cp /opt/lib com.example.Main" in argv
    finally:
        drv.stop_task(h, 2.0)


def test_qemu_command_line_and_port_map(stub_path, tmp_path):
    install, log = stub_path
    install("qemu-system-x86_64",
            "QEMU emulator version 6.2.0")
    drv = QemuDriver()
    assert drv.available()
    assert drv.fingerprint()["driver.qemu.version"] == "6.2.0"

    (tmp_path / "linux.img").write_bytes(b"\x00")
    ctx = {
        "task_dir": str(tmp_path),
        "resources": {"cpu": 500, "memory_mb": 512},
        "alloc_networks": [
            {"reserved_ports": [],
             "dynamic_ports": [{"label": "ssh", "value": 22000}]}],
    }
    h = drv.start_task("vm", {
        "image_path": "linux.img",
        "accelerator": "kvm",
        "port_map": {"ssh": 22},
        "args": ["-nodefaults"],
    }, {}, ctx=ctx)
    try:
        deadline = time.time() + 5
        while time.time() < deadline and not log.exists():
            time.sleep(0.05)
        argv = log.read_text().strip()
        assert "-machine type=pc,accel=kvm" in argv
        assert "-m 512M" in argv
        assert f"-drive file={tmp_path}/linux.img" in argv
        assert "-nographic" in argv
        # hostfwd maps the scheduler's host port to the guest port
        # (driver.go:449)
        assert "hostfwd=tcp::22000-:22" in argv
        assert argv.endswith("-nodefaults")
    finally:
        drv.stop_task(h, 2.0)


def test_qemu_unknown_port_label_errors(stub_path, tmp_path):
    install, _log = stub_path
    install("qemu-system-x86_64")
    (tmp_path / "img").write_bytes(b"\x00")
    with pytest.raises(RuntimeError, match="unknown port label"):
        QemuDriver().start_task("vm", {
            "image_path": str(tmp_path / "img"),
            "port_map": {"web": 80},
        }, {}, ctx={"alloc_networks": []})


def test_conditional_fingerprint_without_binaries(tmp_path, monkeypatch):
    """Hosts without java/qemu drop the drivers (client probe)."""
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not JavaDriver().available()
    assert not QemuDriver().available()


def test_qemu_config_spec_decodes_port_map():
    """The typed-config layer accepts map(number) (hclspec map
    support), including HCL's repeated-block list-of-dicts shape."""
    from nomad_tpu_torch.plugins.hclspec import SpecError, decode
    spec = QemuDriver.CONFIG_SPEC
    out = decode(spec, {"image_path": "x.img",
                        "port_map": {"ssh": 22}})
    assert out["port_map"] == {"ssh": 22}
    out = decode(spec, {"image_path": "x.img",
                        "port_map": [{"ssh": 22}, {"web": 80}]})
    assert out["port_map"] == {"ssh": 22, "web": 80}
    with pytest.raises(SpecError):
        decode(spec, {"image_path": "x.img", "port_map": {"ssh": "x"}})
