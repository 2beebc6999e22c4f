"""docklog: the external container log streamer.

Reference: drivers/docker/docklog/docklog.go — the docker driver
launches `nomad docklog` as a separate process that follows a
container's log stream and writes the task's rotated log files, so log
capture keeps running while the client agent (or the driver plugin)
restarts. Here the spec arrives as JSON on stdin, the process detaches
into its own session, follows `GET /containers/{id}/logs?follow=1`
over the Docker unix socket (demuxing the stream frames), and exits
when the container stops.

Invoked as: python -m nomad_tpu_torch.client.docklog   (spec on STDIN)
spec: {socket_path, container_id, task_name, log_dir,
       log_max_files, log_max_file_size_mb, since}
"""

from __future__ import annotations

import http.client
import json
import os
import struct
import sys
import time


def _connect(socket_path: str):
    from .docker_driver import _UnixHTTPConnection
    return _UnixHTTPConnection(socket_path, timeout=300.0)


def follow(spec: dict) -> int:
    from .logmon import RotatingWriter
    cid = spec["container_id"]
    task = spec.get("task_name", "task")
    log_dir = spec["log_dir"]
    max_files = int(spec.get("log_max_files", 10))
    max_mb = int(spec.get("log_max_file_size_mb", 10))
    since = int(spec.get("since", 0))
    out_w = RotatingWriter(log_dir, f"{task}.stdout", max_files, max_mb)
    err_w = RotatingWriter(log_dir, f"{task}.stderr", max_files, max_mb)
    writers = {1: out_w, 2: err_w}

    announced = False
    while True:
        conn = None
        # the reconnect cursor is the CONNECT time, not per-frame
        # wall-clock: frames buffered behind a slow reader carry
        # emission timestamps older than "now", and a per-frame cursor
        # would drop them on reconnect. Connect-time resume can
        # re-fetch a frame emitted in the same second — duplicates are
        # the acceptable side; loss is not.
        next_since = int(time.time())
        try:
            conn = _connect(spec["socket_path"])
            conn.request(
                "GET",
                f"/containers/{cid}/logs?follow=1&stdout=1&stderr=1"
                f"&since={since}")
            resp = conn.getresponse()
            if resp.status >= 400:
                return 1
            if not announced:
                # startup handshake for the spawning driver
                sys.stdout.write("OK\n")
                sys.stdout.flush()
                announced = True
            # demux the Engine API stream frames:
            # [stream:1][pad:3][len:4][payload]
            while True:
                header = resp.read(8)
                if len(header) < 8:
                    break               # stream closed
                stream_id = header[0]
                (length,) = struct.unpack(">I", header[4:8])
                payload = resp.read(length) if length else b""
                w = writers.get(stream_id, out_w)
                w.write(payload)
        except (OSError, http.client.HTTPException):
            pass
        finally:
            if conn is not None:
                try:
                    conn.close()
                except Exception:
                    pass
        # stream ended: container stopped, dockerd restarted, or a
        # transient error — exit if the container is gone, else
        # reconnect and resume from `since` (docklog.go retry loop)
        try:
            conn = _connect(spec["socket_path"])
            conn.request("GET", f"/containers/{cid}/json")
            resp = conn.getresponse()
            if resp.status >= 400:
                break
            info = json.loads(resp.read() or b"{}")
            if not (info.get("State") or {}).get("Running"):
                break
        except (OSError, http.client.HTTPException, ValueError):
            break
        finally:
            try:
                conn.close()
            except Exception:
                pass
        since = next_since
        time.sleep(0.5)
    for w in writers.values():
        try:
            w.close()
        except Exception:
            pass
    return 0


def main() -> int:
    spec = json.loads(sys.stdin.read())
    try:
        os.setsid()     # survive the client agent
    except OSError:
        pass
    return follow(spec)


if __name__ == "__main__":
    sys.exit(main())
