"""Python API client for the HTTP API (the api/ Go SDK equivalent,
reference: api/api.go NewClient + typed wrappers)."""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Optional


class ApiError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class ApiClient:
    def __init__(self, address: str = "http://127.0.0.1:4646",
                 region: str = "",
                 token: str = ""):
        self.address = address.rstrip("/")
        self.token = token
        # foreign region: every request carries ?region= so the local
        # agent forwards it (nomad/rpc.go forwardRegion)
        self.region = region

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 params: Optional[dict] = None, raw: bool = False) -> Any:
        url = self.address + path
        if self.region:
            params = dict(params or {})
            params.setdefault("region", self.region)
        if params:
            from urllib.parse import urlencode
            url += "?" + urlencode(params)
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["X-Nomad-Token"] = self.token
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=310) as resp:
                payload = resp.read()
                if raw:
                    # non-JSON bodies (Prometheus text exposition)
                    return payload.decode("utf-8", "replace")
                return json.loads(payload or "null")
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", str(e))
            except Exception:
                msg = str(e)
            raise ApiError(e.code, msg)
        except urllib.error.URLError as e:
            raise ApiError(0, f"unable to reach agent at {self.address}: "
                              f"{e.reason}")

    # -- jobs ----------------------------------------------------------
    def register_job(self, spec, check_index: Optional[int] = None
                     ) -> dict:
        body = {"Job": spec}
        if check_index is not None:
            body["EnforceIndex"] = True
            body["JobModifyIndex"] = int(check_index)
        return self._request("PUT", "/v1/jobs", body)

    def register_jobs_bulk(self, specs: list) -> list:
        """Bulk register: PUT /v1/jobs with an array body —
        the agent coalesces the whole batch into one raft entry.
        Each element may be a job spec dict or an {"Job": spec}
        envelope; returns one result per input in order, either
        {"EvalID", "JobModifyIndex"} or {"Error"}."""
        body = [s if isinstance(s, dict) and ("Job" in s or "job" in s)
                else {"Job": s} for s in specs]
        return self._request("PUT", "/v1/jobs", body)

    def list_jobs(self, prefix: str = "") -> list:
        return self._request("GET", "/v1/jobs",
                             params={"prefix": prefix} if prefix else None)

    def get_job(self, job_id: str) -> dict:
        return self._request("GET", f"/v1/job/{job_id}")

    def deregister_job(self, job_id: str, purge: bool = False) -> dict:
        return self._request("DELETE", f"/v1/job/{job_id}",
                             params={"purge": str(purge).lower()})

    def job_allocations(self, job_id: str) -> list:
        return self._request("GET", f"/v1/job/{job_id}/allocations")

    def job_evaluations(self, job_id: str) -> list:
        return self._request("GET", f"/v1/job/{job_id}/evaluations")

    def job_summary(self, job_id: str) -> dict:
        return self._request("GET", f"/v1/job/{job_id}/summary")

    # -- nodes ---------------------------------------------------------
    def list_nodes(self) -> list:
        return self._request("GET", "/v1/nodes")

    def get_node(self, node_id: str) -> dict:
        return self._request("GET", f"/v1/node/{node_id}")

    def node_allocations(self, node_id: str) -> list:
        return self._request("GET", f"/v1/node/{node_id}/allocations")

    def set_node_eligibility(self, node_id: str, eligible: bool) -> dict:
        return self._request("POST", f"/v1/node/{node_id}/eligibility",
                             {"Eligibility":
                              "eligible" if eligible else "ineligible"})

    def drain_node(self, node_id: str, deadline_s: float = 0.0,
                   mark_eligible: bool = False,
                   enable: bool = True) -> dict:
        spec = {"Deadline": deadline_s} if enable else None
        return self._request("POST", f"/v1/node/{node_id}/drain",
                             {"DrainSpec": spec,
                              "MarkEligible": mark_eligible})

    def plan_job(self, job_id: str, spec, diff: bool = True) -> dict:
        return self._request("POST", f"/v1/job/{job_id}/plan",
                             {"Job": spec, "Diff": diff})

    def scale_job(self, job_id: str, group: str, count: int,
                  message: str = "") -> dict:
        return self._request("POST", f"/v1/job/{job_id}/scale",
                             {"Count": count, "Target": {"Group": group},
                              "Message": message})

    def list_scaling_policies(self, job: str = "",
                              policy_type: str = "") -> list:
        """GET /v1/scaling/policies (nomad/scaling_endpoint.go:24)."""
        params = {}
        if job:
            params["job"] = job
        if policy_type:
            params["type"] = policy_type
        return self._request("GET", "/v1/scaling/policies", params=params)

    def get_scaling_policy(self, policy_id: str) -> dict:
        """GET /v1/scaling/policy/:id (nomad/scaling_endpoint.go:90)."""
        return self._request("GET", f"/v1/scaling/policy/{policy_id}")

    def job_scale_status(self, job_id: str) -> dict:
        return self._request("GET", f"/v1/job/{job_id}/scale")

    def job_deployments(self, job_id: str) -> list:
        return self._request("GET", f"/v1/job/{job_id}/deployments")

    def job_versions(self, job_id: str) -> list:
        return self._request("GET", f"/v1/job/{job_id}/versions")

    def revert_job(self, job_id: str, version: int) -> dict:
        return self._request("POST", f"/v1/job/{job_id}/revert",
                             {"JobID": job_id, "JobVersion": version})

    # -- deployments ---------------------------------------------------
    def list_deployments(self, prefix: str = "") -> list:
        return self._request("GET", "/v1/deployments",
                             params={"prefix": prefix} if prefix else None)

    def get_deployment(self, deployment_id: str) -> dict:
        return self._request("GET", f"/v1/deployment/{deployment_id}")

    def deployment_allocations(self, deployment_id: str) -> list:
        return self._request("GET",
                             f"/v1/deployment/allocations/{deployment_id}")

    def promote_deployment(self, deployment_id: str,
                           groups: Optional[list] = None) -> dict:
        return self._request("POST", f"/v1/deployment/promote/{deployment_id}",
                             {"DeploymentID": deployment_id, "Groups": groups})

    def fail_deployment(self, deployment_id: str) -> dict:
        return self._request("POST", f"/v1/deployment/fail/{deployment_id}",
                             {})

    def pause_deployment(self, deployment_id: str, pause: bool) -> dict:
        return self._request("POST", f"/v1/deployment/pause/{deployment_id}",
                             {"Pause": pause})

    # -- allocs / evals ------------------------------------------------
    def alloc_fs_stream(self, alloc_id: str, path: str = "",
                        offset: int = 0, task: str = "",
                        log_type: str = "", wait_s: float = 0.0) -> list:
        """GET /v1/client/fs/stream/:alloc — framed file/log stream
        (client/lib/streamframer shape over poll round trips). Returns
        decoded frames [{File, Offset, Data(bytes), Heartbeat?,
        FileEvent?}]; resume from the last frame's Offset+len(Data)."""
        import base64
        params = {"offset": offset, "wait_s": wait_s}
        if path:
            params["path"] = path
        if task:
            params["task"] = task
        if log_type:
            params["log_type"] = log_type
        r = self._request("GET", f"/v1/client/fs/stream/{alloc_id}",
                          params=params)
        frames = []
        for f in r.get("Frames", []):
            f = dict(f)
            f["Data"] = base64.b64decode(f.get("Data") or "")
            frames.append(f)
        return frames

    def alloc_exec_start(self, alloc_id: str, cmd: list,
                         task: str = "") -> str:
        """POST /v1/client/allocation/:alloc/exec → session id
        (AllocExecRequest, client/alloc_endpoint.go:163)."""
        r = self._request("POST", f"/v1/client/allocation/{alloc_id}/exec",
                          {"Task": task, "Cmd": list(cmd)})
        return r["SessionID"]

    def alloc_exec_io(self, alloc_id: str, session_id: str,
                      stdin: bytes = b"", close_stdin: bool = False,
                      wait_s: float = 0.0, signal: int = 0) -> dict:
        """One stdin/stdout round trip of an exec session. Returns
        {stdout: bytes, stderr: bytes, exited: bool, exit_code: int}."""
        import base64
        body = {"Stdin": base64.b64encode(stdin).decode()
                if stdin else "",
                "CloseStdin": close_stdin, "WaitS": wait_s}
        if signal:
            body["Signal"] = signal
        r = self._request(
            "POST", f"/v1/client/allocation/{alloc_id}/exec/{session_id}",
            body)
        return {"stdout": base64.b64decode(r.get("Stdout") or ""),
                "stderr": base64.b64decode(r.get("Stderr") or ""),
                "exited": bool(r.get("Exited")),
                "exit_code": int(r.get("ExitCode", -1))}

    def alloc_exec_stop(self, alloc_id: str, session_id: str) -> None:
        self._request(
            "DELETE",
            f"/v1/client/allocation/{alloc_id}/exec/{session_id}")

    def alloc_stats(self, alloc_id: str) -> dict:
        """GET /v1/client/allocation/:alloc/stats — live task-level
        AllocResourceUsage from the owning client's sampler
        (client/alloc_endpoint.go Stats)."""
        return self._request(
            "GET", f"/v1/client/allocation/{alloc_id}/stats")

    def client_host_stats(self, node_id: str = "",
                          history: bool = False,
                          last: Optional[int] = None) -> dict:
        """GET /v1/client/stats — a node's HostStats, proxied by the
        server to the owning client (stats_endpoint.go); node_id may
        be omitted on a single-node cluster. history=True attaches the
        client-side retained ring."""
        params = {}
        if node_id:
            params["node_id"] = node_id
        if history:
            params["history"] = "true"
            if last:
                params["n"] = str(last)
        return self._request("GET", "/v1/client/stats",
                             params=params or None)

    def get_allocation(self, alloc_id: str) -> dict:
        return self._request("GET", f"/v1/allocation/{alloc_id}")

    def list_allocations(self) -> list:
        return self._request("GET", "/v1/allocations")

    def get_evaluation(self, eval_id: str) -> dict:
        return self._request("GET", f"/v1/evaluation/{eval_id}")

    def search(self, prefix: str, context: str = "all") -> dict:
        return self._request("POST", "/v1/search",
                             {"Prefix": prefix, "Context": context})

    def stream_events(self, topics: Optional[list] = None,
                      index: int = 0):
        """Generator of event batches from /v1/event/stream (NDJSON).
        topics: ["Job:my-job", "Node:*"]-style filters."""
        from urllib.parse import urlencode
        params = [("topic", t) for t in (topics or [])] + [("index", index)]
        if self.region:
            params.append(("region", self.region))
        url = f"{self.address}/v1/event/stream?{urlencode(params)}"
        req = urllib.request.Request(url)
        with urllib.request.urlopen(req, timeout=310) as resp:
            for line in resp:
                line = line.strip()
                if not line or line == b"{}":
                    continue
                yield json.loads(line)

    # -- volumes ---------------------------------------------------------
    def list_volumes(self, namespace: str = "default") -> list:
        return self._request("GET", "/v1/volumes",
                             params={"namespace": namespace})

    def get_volume(self, volume_id: str,
                   namespace: str = "default") -> dict:
        return self._request("GET", f"/v1/volume/csi/{volume_id}",
                             params={"namespace": namespace})

    def register_volume(self, spec: dict,
                        namespace: str = "default") -> dict:
        vol_id = spec.get("id", spec.get("ID", ""))
        if not vol_id:
            raise ApiError(400, "volume spec requires an id")
        return self._request("PUT", f"/v1/volume/csi/{vol_id}",
                             {"Volume": spec},
                             params={"namespace": namespace})

    def deregister_volume(self, volume_id: str, force: bool = False,
                          namespace: str = "default") -> dict:
        return self._request(
            "DELETE", f"/v1/volume/csi/{volume_id}",
            params={"namespace": namespace,
                    "force": str(force).lower()})

    # -- operator --------------------------------------------------------
    def snapshot_save(self) -> dict:
        return self._request("GET", "/v1/operator/snapshot")

    def snapshot_restore(self, snapshot: dict) -> dict:
        return self._request("PUT", "/v1/operator/snapshot",
                             {"snapshot": snapshot})

    def autopilot_config(self) -> dict:
        return self._request("GET",
                             "/v1/operator/autopilot/configuration")

    def governor(self) -> dict:
        return self._request("GET", "/v1/operator/governor")

    def trace(self, params: Optional[dict] = None) -> dict:
        """Eval flight recorder: recent span trees, tail exemplars,
        and per-stage percentiles; params: n, exemplars=true,
        format=chrome (Perfetto-loadable trace-event JSON)."""
        return self._request("GET", "/v1/operator/trace",
                             params=params)

    def set_autopilot_config(self, config: dict) -> dict:
        return self._request("PUT",
                             "/v1/operator/autopilot/configuration",
                             config)

    # -- namespaces ------------------------------------------------------
    def list_namespaces(self) -> list:
        return self._request("GET", "/v1/namespaces")

    def get_namespace(self, name: str) -> dict:
        return self._request("GET", f"/v1/namespace/{name}")

    def apply_namespace(self, name: str, description: str = "",
                        meta: Optional[dict] = None) -> dict:
        return self._request("PUT", f"/v1/namespace/{name}",
                             {"name": name, "description": description,
                              "meta": meta or {}})

    def delete_namespace(self, name: str) -> dict:
        return self._request("DELETE", f"/v1/namespace/{name}")

    # -- service catalog ------------------------------------------------
    def list_services(self, namespace: str = "default") -> list:
        return self._request("GET", "/v1/services",
                             params={"namespace": namespace})

    def get_service(self, name: str, namespace: str = "default") -> list:
        return self._request("GET", f"/v1/service/{name}",
                             params={"namespace": namespace})

    def delete_service_registration(self, name: str, reg_id: str) -> dict:
        return self._request("DELETE", f"/v1/service/{name}/{reg_id}")

    def agent_self(self) -> dict:
        return self._request("GET", "/v1/agent/self")

    def metrics(self, format: str = "") -> Any:
        """InmemSink snapshot (JSON), or the Prometheus text
        exposition when format='prometheus' (returned as str)."""
        if format == "prometheus":
            return self._request("GET", "/v1/metrics",
                                 params={"format": "prometheus"},
                                 raw=True)
        return self._request("GET", "/v1/metrics")

    def telemetry(self, last: Optional[int] = None) -> dict:
        """Retained telemetry history ring: chronological
        series + derived rates from /v1/operator/telemetry."""
        return self._request(
            "GET", "/v1/operator/telemetry",
            params={"n": str(last)} if last else None)

    def flatness(self) -> dict:
        """Live steady-state verdict: bench/soak.flatness_verdict run
        over the in-process telemetry ring."""
        return self._request("GET", "/v1/operator/flatness")

    def agent_profile(self, seconds: float = 1.0) -> dict:
        return self._request("GET", "/v1/agent/pprof/profile",
                             params={"seconds": seconds})

    def agent_threads(self) -> dict:
        return self._request("GET", "/v1/agent/pprof/threads")

    # -- ACL ------------------------------------------------------------
    def acl_bootstrap(self) -> dict:
        return self._request("POST", "/v1/acl/bootstrap")

    def acl_policies(self) -> list:
        return self._request("GET", "/v1/acl/policies")

    def acl_policy(self, name: str) -> dict:
        return self._request("GET", f"/v1/acl/policy/{name}")

    def acl_upsert_policy(self, name: str, rules: str,
                          description: str = "") -> dict:
        return self._request("PUT", f"/v1/acl/policy/{name}",
                             {"rules": rules, "description": description})

    def acl_delete_policy(self, name: str) -> dict:
        return self._request("DELETE", f"/v1/acl/policy/{name}")

    def acl_tokens(self) -> list:
        return self._request("GET", "/v1/acl/tokens")

    def acl_create_token(self, name: str = "", type_: str = "client",
                         policies=None) -> dict:
        return self._request("PUT", "/v1/acl/token",
                             {"name": name, "type": type_,
                              "policies": policies or []})

    def acl_delete_token(self, accessor_id: str) -> dict:
        return self._request("DELETE", f"/v1/acl/token/{accessor_id}")

    def acl_token_self(self) -> dict:
        return self._request("GET", "/v1/acl/token/self")

    def list_event_sinks(self) -> list:
        return self._request("GET", "/v1/event/sinks")

    def upsert_event_sink(self, address: str, sink_id: str = "",
                          topics: Optional[dict] = None,
                          type_: str = "webhook") -> dict:
        body = {"Address": address, "Type": type_,
                "Topics": topics or {}}
        if sink_id:
            body["ID"] = sink_id
        return self._request("PUT", "/v1/event/sink", body)

    def delete_event_sink(self, sink_id: str) -> dict:
        return self._request("DELETE", f"/v1/event/sink/{sink_id}")

    def scheduler_config(self) -> dict:
        return self._request("GET", "/v1/operator/scheduler/configuration")
