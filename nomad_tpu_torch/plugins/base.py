"""The plugin process boundary.

Reference: go-plugin as used by plugins/base/plugin.go:26-35 — the host
launches the plugin as a subprocess with a magic-cookie env var (so a
plugin binary run by hand exits with an explanation), the plugin prints
a one-line handshake (protocol version + listen address) on stdout, and
the two sides speak RPC from then on. Here the transport is the same
length-prefixed msgpack framing as the cluster RPC layer (rpc/codec).

Driver plugin surface (plugins/drivers/driver.go DriverPlugin):
    Driver.Fingerprint              -> attribute map
    Driver.StartTask                -> handle id + start time
    Driver.WaitTask  {id, timeout}  -> {done, exit_code} (blocking;
                                       concurrent waits ride the seq
                                       demultiplexing)
    Driver.StopTask  {id, timeout}
    Driver.RecoverTask {state}      -> handle id (re-attach)
    Driver.InspectTask {id}         -> handle state
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

HANDSHAKE_COOKIE_KEY = "NOMAD_TPU_TORCH_PLUGIN_COOKIE"
HANDSHAKE_COOKIE_VALUE = "nomad-tpu-driver-plugin-v1"
HANDSHAKE_PREFIX = "NOMAD_TPU_PLUGIN|1|"


def build_driver_methods(driver) -> Dict:
    """RPC method table wrapping an in-proc driver instance."""
    handles: Dict[str, object] = {}

    def fingerprint(_args):
        return {"attributes": driver.fingerprint()}

    def start_task(args):
        h = driver.start_task(args["task_name"], args.get("config") or {},
                              args.get("env") or {},
                              ctx=args.get("ctx") or None)
        handles[h.id] = h
        return {"handle_id": h.id, "started_at": h.started_at}

    def wait_task(args):
        h = handles.get(args["handle_id"])
        if h is None:
            raise KeyError(f"unknown handle {args['handle_id']}")
        done = h.wait(float(args.get("timeout_s") or 0) or None)
        return {"done": bool(done), "exit_code": h.exit_code,
                "finished_at": h.finished_at}

    def stop_task(args):
        h = handles.get(args["handle_id"])
        if h is None:
            return {}
        driver.stop_task(h, float(args.get("timeout_s", 5.0)))
        return {"exit_code": h.exit_code}

    def recover_task(args):
        recover = getattr(driver, "recover_task", None)
        h = recover(args["state"]) if recover else None
        if h is None:
            return {"handle_id": None}
        handles[h.id] = h
        return {"handle_id": h.id, "started_at": h.started_at}

    def inspect_task(args):
        h = handles.get(args["handle_id"])
        if h is None:
            return {"exists": False}
        return {"exists": True, "done": h.done(), "exit_code": h.exit_code,
                "state": h.recoverable_state()}

    def destroy_task(args):
        handles.pop(args["handle_id"], None)
        return {}

    def config_schema(_args):
        # hclspec over the boundary (plugins/base/plugin.go
        # ConfigSchema): the host decodes user config against the
        # plugin's declared schema
        from .hclspec import describe
        spec = getattr(driver, "CONFIG_SPEC", None)
        return {"schema": describe(spec) if spec else None}

    return {
        "Driver.ConfigSchema": config_schema,
        "Driver.Fingerprint": fingerprint,
        "Driver.StartTask": start_task,
        "Driver.WaitTask": wait_task,
        "Driver.StopTask": stop_task,
        "Driver.RecoverTask": recover_task,
        "Driver.InspectTask": inspect_task,
        "Driver.DestroyTask": destroy_task,
    }


def serve_plugin(driver, out=None, methods: Optional[Dict] = None) -> None:
    """Plugin-side main: verify the handshake cookie, listen, print the
    handshake line, serve until stdin closes (the host's death closes
    our stdin, so orphaned plugins exit — go-plugin's supervision
    contract). `methods` overrides the driver method table (device
    plugins serve Device.* instead)."""
    if os.environ.get(HANDSHAKE_COOKIE_KEY) != HANDSHAKE_COOKIE_VALUE:
        print("This binary is a plugin and must be launched by the "
              "nomad-tpu client agent", file=sys.stderr)
        sys.exit(1)
    from ..rpc.server import RpcServer
    rpc = RpcServer(methods=methods if methods is not None
                    else build_driver_methods(driver))
    rpc.start()
    out = out or sys.stdout
    out.write(HANDSHAKE_PREFIX + rpc.addr + "\n")
    out.flush()
    # serve until the host goes away
    try:
        while True:
            line = sys.stdin.readline()
            if not line:
                break
    except KeyboardInterrupt:
        pass
    rpc.shutdown()
