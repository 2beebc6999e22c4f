"""Device plugins behind the process boundary.

Reference: plugins/device/device.go — DevicePlugin exposes
Fingerprint (device groups + attributes), Reserve (a container
reservation: env vars / mounts for the chosen instance ids), and
Stats; devices/gpu/nvidia runs behind go-plugin. Here the CUDA card's
fingerprint (through torch.cuda, where the NVIDIA plugin asks NVML)
moves behind the same RPC boundary the driver plugins use.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ..rpc.client import RpcClient, RpcError
from ..utils.locks import make_lock
from .base import (HANDSHAKE_COOKIE_KEY, HANDSHAKE_COOKIE_VALUE,
                   HANDSHAKE_PREFIX)

LOG = logging.getLogger("nomad_tpu.plugins.device")


class AcceleratorDevicePlugin:
    """In-proc implementation served by the plugin process: the CUDA
    cards' fingerprint + reservation env + runtime stats
    (devices/gpu/nvidia/device.go)."""

    name = "accelerator"
    CONFIG_SPEC: Dict = {}

    def fingerprint(self) -> List[Dict]:
        from ..client.agent import fingerprint_accelerator_devices
        from ..utils.codec import to_wire
        return [to_wire(g) for g in fingerprint_accelerator_devices()]

    def reserve(self, device_ids: List[str]) -> Dict:
        """ContainerReservation (plugins/device/device.go Reserve): the
        env var that scopes the task to its reserved instances, the
        cards' indices as NVIDIA's plugin sets NVIDIA_VISIBLE_DEVICES."""
        return {"envs": {
            "CUDA_VISIBLE_DEVICES": ",".join(
                d.rsplit("-", 1)[-1] for d in device_ids),
        }}

    def stats(self) -> List[Dict]:
        """Each card's memory: used and total on the whole card
        (torch.cuda.mem_get_info, every process's allocations), and
        what this process's caching allocator holds
        (torch.cuda.memory_stats)."""
        import torch
        if not torch.cuda.is_available():
            return []
        out = []
        for i in range(torch.cuda.device_count()):
            free, total = torch.cuda.mem_get_info(i)
            ms = torch.cuda.memory_stats(i)
            out.append({
                "id": f"gpu-{i}", "healthy": True,
                "memory_used_bytes": int(total - free),
                "memory_limit_bytes": int(total),
                "allocator_bytes_in_use": int(
                    ms.get("allocated_bytes.all.current", 0)),
            })
        return out


DEVICE_PLUGIN_CATALOG = {
    "accelerator": AcceleratorDevicePlugin,
}


def build_device_methods(plugin) -> Dict:
    """RPC method table for a device plugin (Fingerprint/Reserve/Stats
    + ConfigSchema, plugins/device/device.go)."""
    def fingerprint(_args):
        return {"groups": plugin.fingerprint()}

    def reserve(args):
        return plugin.reserve(list(args.get("device_ids") or []))

    def stats(_args):
        return {"devices": plugin.stats()}

    def config_schema(_args):
        from .hclspec import describe
        spec = getattr(plugin, "CONFIG_SPEC", None)
        return {"schema": describe(spec) if spec else None}

    return {
        "Device.Fingerprint": fingerprint,
        "Device.Reserve": reserve,
        "Device.Stats": stats,
        "Device.ConfigSchema": config_schema,
    }


class ExternalDevicePlugin:
    """Host side: launch + supervise the device plugin process and
    proxy the DevicePlugin interface (the devicemanager role,
    client/pluginmanager/devicemanager)."""

    def __init__(self, plugin_name: str = "accelerator",
                 python: str = sys.executable):
        self.name = plugin_name
        self.python = python
        self._lock = make_lock()
        self._proc: Optional[subprocess.Popen] = None
        self._rpc: Optional[RpcClient] = None

    def _ensure_running(self) -> RpcClient:
        with self._lock:
            if self._rpc is not None and self._proc is not None \
                    and self._proc.poll() is None:
                return self._rpc
            if self._proc is not None:
                LOG.warning("device plugin %s died (rc=%s); relaunching",
                            self.name, self._proc.poll())
            env = dict(os.environ)
            env[HANDSHAKE_COOKIE_KEY] = HANDSHAKE_COOKIE_VALUE
            self._proc = subprocess.Popen(
                [self.python, "-m", "nomad_tpu_torch.plugins.launcher",
                 "--device", self.name],
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
                    f"device plugin {self.name} bad handshake: {line!r}")
            self._rpc = RpcClient(line[len(HANDSHAKE_PREFIX):])
            return self._rpc

    def call(self, method: str, args: dict, timeout_s: float = 60.0):
        try:
            return self._ensure_running().call(method, args,
                                               timeout_s=timeout_s)
        except RpcError:
            time.sleep(0.1)
            with self._lock:
                if self._proc is not None and \
                        self._proc.poll() is not None and \
                        self._rpc is not None:
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

    # -- DevicePlugin interface ---------------------------------------
    def fingerprint(self) -> List:
        """Device groups as model objects (NodeDeviceResource)."""
        from ..models import NodeDeviceResource
        from ..utils.codec import from_wire
        groups = self.call("Device.Fingerprint", {},
                           timeout_s=180.0)["groups"]
        return [from_wire(NodeDeviceResource, g) for g in groups]

    def reserve(self, device_ids: List[str]) -> Dict:
        return self.call("Device.Reserve", {"device_ids": device_ids})

    def stats(self) -> List[Dict]:
        return self.call("Device.Stats", {})["devices"]
