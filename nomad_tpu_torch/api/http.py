"""North-bound HTTP JSON API.

Reference semantics: command/agent/http.go (route registry :252-350,
blocking-query params index/wait, X-Nomad-Index response header) and the
per-domain handlers in command/agent/*_endpoint.go. Routes:

  GET/PUT  /v1/jobs                    list / register
  GET/DELETE /v1/job/<id>              read / deregister (?purge=true)
  GET      /v1/job/<id>/allocations|evaluations|summary|versions
  GET      /v1/nodes, /v1/node/<id>, /v1/node/<id>/allocations
  POST     /v1/node/<id>/eligibility|drain
  GET      /v1/allocations, /v1/allocation/<id>
  GET      /v1/evaluations, /v1/evaluation/<id>
  GET      /v1/status/leader, /v1/agent/self, /v1/operator/scheduler/configuration
"""

from __future__ import annotations

import http.client
import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..jobspec import parse_job
from ..jobspec.parse import parse_duration_s
from ..models import Job, NODE_SCHED_ELIGIBLE, NODE_SCHED_INELIGIBLE
from ..models.node import DrainSpec, DrainStrategy
from ..server.eval_broker import AdmissionOverloadError
from ..utils.codec import from_wire, to_wire


def _write_chunk(wfile, data: bytes) -> None:
    """One chunked-transfer-encoding frame (shared by the streaming
    endpoints and the federation proxy)."""
    wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
    wfile.flush()


class PlainText:
    """A route payload served verbatim as text/plain instead of JSON
    (the Prometheus exposition at /v1/metrics?format=prometheus)."""

    __slots__ = ("text", "content_type")

    def __init__(self, text: str,
                 content_type: str = "text/plain; version=0.0.4; "
                                     "charset=utf-8"):
        self.text = text
        self.content_type = content_type


class HTTPApiServer:
    def __init__(self, server, host: str = "127.0.0.1", port: int = 4646,
                 alloc_dir_bases=None, region_peers=None):
        self.server = server
        # where co-located clients keep alloc dirs — lets the agent
        # serve fs/logs endpoints directly (the reference forwards
        # these to the client over RPC, client/fs_endpoint.go). Given,
        # exactly these (an agent passes its local clients' and none
        # without them); left out, the clients' default under the
        # temporary directory
        if alloc_dir_bases is None:
            import tempfile
            alloc_dir_bases = [
                os.path.join(tempfile.gettempdir(), "nomad-tpu-allocs")]
        self.alloc_dir_bases = list(alloc_dir_bases)
        # multi-region federation (nomad/rpc.go forwardRegion): other
        # regions' agent addresses; a request stamped with a foreign
        # region proxies there wholesale, and the remote region
        # enforces its own ACLs. Defaults to the server's configured
        # peers (the same map replication uses).
        self.region_peers: dict = dict(
            region_peers if region_peers is not None
            else getattr(server.config, "region_peers", None) or {})
        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _respond(self, code: int, payload, index: Optional[int] = None,
                         headers: Optional[dict] = None):
                if isinstance(payload, PlainText):
                    body = payload.text.encode()
                    ctype = payload.content_type
                else:
                    body = json.dumps(payload).encode()
                    ctype = "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if index is not None:
                    self.send_header("X-Nomad-Index", str(index))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code: int, msg: str,
                       headers: Optional[dict] = None):
                self._respond(code, {"error": msg}, headers=headers)

            def _read_body_bytes(self) -> bytes:
                """Read (and cache) the raw request body — callers that
                peek at it before routing must not consume it twice."""
                cached = getattr(self, "_body_cache", None)
                if cached is None:
                    length = int(self.headers.get("Content-Length", 0))
                    cached = self.rfile.read(length) if length else b""
                    self._body_cache = cached
                return cached

            def _body(self):
                raw = self._read_body_bytes()
                if not raw:
                    return {}
                return json.loads(raw)

            def _handle(self, method: str):
                try:
                    url = urlparse(self.path)
                    # embedded web UI (the reference serves its Ember
                    # build the same way); data requests out of the
                    # page carry the ACL token themselves
                    if method == "GET" and (
                            url.path == "/" or url.path == "/ui"
                            or url.path.startswith("/ui/")):
                        from .ui import INDEX_HTML
                        body = INDEX_HTML.encode()
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "text/html; charset=utf-8")
                        self.send_header("Content-Length",
                                         str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    q = {k: v[0] for k, v in parse_qs(url.query).items()}
                    token = self.headers.get("X-Nomad-Token", "")
                    # region-keyed forwarding (nomad/rpc.go forward:502
                    # -> forwardRegion:638): a foreign-region stamp
                    # proxies the request WHOLESALE before any local
                    # work — local blocking-query indexes, ACLs, and
                    # stream dispatch all belong to the owning region
                    region = q.get("region", "")
                    local_region = getattr(api.server.config, "region",
                                           "global")
                    if region and region != local_region:
                        return api.proxy_region(self, region, method, url)
                    # ACL/namespace WRITES belong to the authoritative
                    # region (the reference forwards them,
                    # acl_endpoint.go/namespace_endpoint.go); accepting
                    # them locally would let the replicator silently
                    # delete them on its next sync
                    auth = getattr(api.server.config,
                                   "authoritative_region", "")
                    if auth and auth != local_region and \
                            method in ("PUT", "POST", "DELETE") and \
                            api._forwards_to_authoritative(self, method,
                                                           url.path):
                        return api.proxy_region(self, auth, method, url)
                    if url.path == "/v1/agent/monitor" and method == "GET":
                        acl = api.server.resolve_token(token)
                        if not (acl.is_management() or acl.allow_agent_read()):
                            raise PermissionError("Permission denied")
                        return api.stream_monitor(self, q)
                    if url.path == "/v1/event/stream" and method == "GET":
                        acl = api.server.resolve_token(token)
                        if not (acl.is_management() or acl.allow_namespace(
                                q.get("namespace", "default"))):
                            raise PermissionError("Permission denied")
                        # topics repeat: ?topic=Job:myjob&topic=Node:*
                        raw = parse_qs(url.query).get("topic", [])
                        return api.stream_events(self, raw,
                                                 int(q.get("index", 0)))
                    # blocking query support (http.go parseWait)
                    if "index" in q:
                        wait_s = parse_duration_s(q.get("wait", "5m"), 300.0)
                        api.server.store.block_min_index(
                            int(q["index"]), timeout_s=min(wait_s, 300.0))
                    body_fn = None
                    if method in ("PUT", "POST"):
                        handler = self

                        def body_fn():
                            return handler._body()
                        # decode-free size signal for the write-path
                        # admission hook: shed happens on the header,
                        # never after the JSON is already materialized
                        body_fn.hint_bytes = int(
                            self.headers.get("Content-Length") or 0)
                    result = api.route(method, url.path, q, body_fn,
                                       token=token)
                    if result is None:
                        self._error(404, "not found")
                    else:
                        payload, index = result
                        self._respond(200, payload, index)
                except PermissionError as e:
                    self._error(403, str(e) or "Permission denied")
                except AdmissionOverloadError as e:
                    # backpressure escalation: the broker's shed valve
                    # is full — refuse at the edge with Retry-After so
                    # well-behaved clients back off instead of piling
                    # onto the delayed heap
                    self._error(429, str(e), headers={
                        "Retry-After":
                        str(max(1, int(round(e.retry_after_s))))})
                except ValueError as e:
                    self._error(400, str(e))
                except KeyError as e:
                    self._error(404, str(e))
                except Exception as e:    # pragma: no cover
                    self._error(500, f"{type(e).__name__}: {e}")

            def do_GET(self):
                self._handle("GET")

            def do_PUT(self):
                self._handle("PUT")

            def do_POST(self):
                self._handle("POST")

            def do_DELETE(self):
                self._handle("DELETE")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="http-api")
        self._thread.start()

    def shutdown(self) -> None:
        """Stop serving, close the listening socket and join the
        serving thread (request threads in flight are daemons)."""
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2)

    # -- ACL enforcement (command/agent http.go wrap + acl checks) -----
    @staticmethod
    def _enforce(acl, method: str, path: str, ns: str) -> None:
        """Raise PermissionError unless the compiled ACL allows the
        route. Capability mapping follows the reference endpoints'
        aclObj checks (job_endpoint.go, node_endpoint.go, ...)."""
        if acl.is_management():
            return

        def need(ok: bool):
            if not ok:
                raise PermissionError("Permission denied")

        write = method in ("PUT", "POST", "DELETE")
        if path == "/v1/status/leader" or path == "/v1/jobs/parse":
            return
        if path.startswith("/v1/acl/"):
            return                      # own authz in the route bodies
        if path == "/v1/jobs":
            need(acl.allow_namespace_operation(
                ns, "submit-job" if write else "list-jobs"))
            return
        if path.startswith("/v1/job/"):
            cap = "read-job"
            if write:
                cap = "submit-job"
                if path.endswith("/scale"):
                    cap = "scale-job"
                elif path.endswith("/dispatch"):
                    cap = "dispatch-job"
            need(acl.allow_namespace_operation(ns, cap))
            return
        if path == "/v1/nodes" or path.startswith("/v1/node/"):
            sub_write = write or path.endswith(("/drain", "/eligibility"))
            need(acl.allow_node_write() if sub_write
                 else acl.allow_node_read())
            return
        if path.startswith(("/v1/allocation", "/v1/evaluation",
                            "/v1/deployment")):
            need(acl.allow_namespace_operation(
                ns, "submit-job" if write else "read-job"))
            return
        if path.startswith("/v1/client/fs/"):
            # logs need read-logs; browsing/reading arbitrary files
            # needs read-fs (the reference splits these capabilities)
            if path.startswith("/v1/client/fs/logs/"):
                need(acl.allow_namespace_operation(ns, "read-logs"))
            else:
                need(acl.allow_namespace_operation(ns, "read-fs"))
            return
        if path == "/v1/client/stats":
            # host stats are node-scoped reads (stats_endpoint.go
            # aclObj.AllowNodeRead)
            need(acl.allow_node_read())
            return
        if path.startswith("/v1/client/allocation/"):
            # restart/signal are lifecycle control; exec is its own,
            # stronger capability (acl.NamespaceCapabilityAllocExec /
            # AllocLifecycle); stats is a plain alloc read
            # (alloc_endpoint.go Stats -> AllowNsOp ReadJob)
            if path.endswith("/stats"):
                need(acl.allow_namespace_operation(ns, "read-job"))
            elif path.endswith(("/restart", "/signal")):
                need(acl.allow_namespace_operation(ns, "alloc-lifecycle"))
            else:
                need(acl.allow_namespace_operation(ns, "alloc-exec"))
            return
        if path == "/v1/volumes" or path.startswith("/v1/volume/"):
            need(acl.allow_namespace_operation(
                ns, "csi-write-volume" if write else "csi-read-volume"))
            return
        if path == "/v1/scaling/policies" or \
                path.startswith("/v1/scaling/policy/"):
            # the autoscaler's read surface needs only job-read
            # capabilities (nomad/scaling_endpoint.go aclObj checks:
            # ListPolicies list-jobs, GetPolicy read-job)
            need(acl.allow_namespace_operation(
                ns, "list-jobs" if path == "/v1/scaling/policies"
                else "read-job"))
            return
        if path == "/v1/namespaces":
            # list is allowed for any namespace capability; the route
            # filters the result to namespaces the token can read
            need(not write and (acl.allow_namespace(ns)
                                or acl.allow_node_read()
                                or acl.allow_operator_read()))
            return
        m_ns = re.match(r"^/v1/namespace/([^/]+)$", path)
        if m_ns:
            # reads authorize against the namespace NAMED IN THE PATH
            # (not the caller-chosen ?namespace= param); writes are an
            # operator surface (namespace_endpoint.go aclObj checks)
            need(acl.allow_operator_write() if write
                 else (acl.allow_namespace(m_ns.group(1))
                       or acl.allow_operator_read()))
            return
        if path == "/v1/services" or path.startswith("/v1/service/"):
            # service discovery reads ride read-job; deregistration is
            # a job-write-shaped operation
            need(acl.allow_namespace_operation(
                ns, "submit-job" if write else "read-job"))
            return
        if path == "/v1/search":
            need(acl.allow_namespace(ns) or acl.allow_node_read())
            return
        if path.startswith("/v1/agent") or path == "/v1/metrics":
            need(acl.allow_agent_write() if write else acl.allow_agent_read())
            return
        if path.startswith(("/v1/operator", "/v1/event/sink")):
            # sink CRUD is an operator surface (event_sink_manager.go)
            need(acl.allow_operator_write() if write
                 else acl.allow_operator_read())
            return
        if path.startswith("/v1/system"):
            need(acl.allow_operator_write())
            return
        raise PermissionError("Permission denied")

    # -- routing -------------------------------------------------------
    def route(self, method: str, path: str, q: dict, body_fn, token: str = ""):
        s = self.server
        store = s.store
        idx = store.latest_index()
        ns = q.get("namespace", "default")

        acl = s.resolve_token(token)
        if s.config.acl_enabled:
            self._enforce(acl, method, path, ns)

        if path.startswith("/v1/acl/"):
            return self._route_acl(method, path, body_fn, acl, token)

        return self._route_main(method, path, q, body_fn, ns, idx,
                                acl=acl)

    def _forwards_to_authoritative(self, handler, method: str,
                                   path: str) -> bool:
        """Which writes belong to the authoritative region: namespace
        CRUD, ACL policy CRUD, and GLOBAL token operations (local
        tokens stay regional — acl_endpoint.go UpsertTokens)."""
        if path.startswith("/v1/namespace/"):
            return True
        if path.startswith("/v1/acl/policy"):
            return True
        if path == "/v1/acl/token" and method in ("PUT", "POST"):
            try:
                body = json.loads(handler._read_body_bytes() or b"{}")
            except ValueError:
                return False
            return bool(body.get("global") or body.get("global_"))
        m = re.match(r"^/v1/acl/token/([^/]+)$", path)
        if m:
            tok = self.server.store.acl_token_by_accessor(m.group(1))
            return tok is not None and tok.global_
        return False

    def proxy_region(self, handler, region: str, method: str, url,
                     body: Optional[bytes] = None) -> None:
        """Proxy one request raw to the named region's agent
        (forwardRegion) and relay the response verbatim — remote status
        codes pass through untouched, and chunked bodies (event/monitor
        streams, blocking queries) relay frame-by-frame. Writes the
        response on `handler` directly."""
        import urllib.error
        import urllib.request
        from urllib.parse import urlencode
        peer = self.region_peers.get(region)
        if not peer:
            raise KeyError(f"no path to region {region!r}")
        # rebuild the query preserving repeated params (?topic=a&topic=b)
        pairs = [(k, v) for k, vs in parse_qs(url.query).items()
                 if k != "region" for v in vs]
        target = f"http://{peer}{url.path}"
        if pairs:
            target += "?" + urlencode(pairs)
        data = body
        if data is None and method in ("PUT", "POST"):
            data = handler._read_body_bytes() or b"{}"
        headers = {"Content-Type": "application/json"}
        token = handler.headers.get("X-Nomad-Token", "")
        if token:
            headers["X-Nomad-Token"] = token
        req = urllib.request.Request(target, data=data, method=method,
                                     headers=headers)
        # read timeout must outlive the remote's 300 s blocking-query
        # cap; streams heartbeat every <=5 s so reads never idle long
        try:
            resp = urllib.request.urlopen(req, timeout=330)
        except urllib.error.HTTPError as e:
            resp = e                     # file-like; relay code + body
        except urllib.error.URLError as e:
            raise RuntimeError(f"no route to region {region!r}: {e.reason}")
        with resp:
            try:
                self._relay_response(handler, resp)
            except (BrokenPipeError, ConnectionResetError, OSError,
                    http.client.HTTPException):
                # either side went away mid-body (HTTPException covers
                # IncompleteRead from a dying remote); headers are
                # already sent, so there's nothing valid left to write
                pass

    @staticmethod
    def _relay_response(handler, resp) -> None:
        code = getattr(resp, "status", None) or resp.code
        handler.send_response(code)
        handler.send_header("Content-Type", resp.headers.get(
            "Content-Type", "application/json"))
        ridx = resp.headers.get("X-Nomad-Index")
        if ridx:
            handler.send_header("X-Nomad-Index", ridx)
        clen = resp.headers.get("Content-Length")
        if clen is not None:
            handler.send_header("Content-Length", clen)
            handler.end_headers()
            handler.wfile.write(resp.read(int(clen)))
            return
        # chunked stream: relay each piece as it arrives (read1 returns
        # what's buffered instead of blocking for a full read)
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            _write_chunk(handler.wfile, chunk)
        handler.wfile.write(b"0\r\n\r\n")

    def _route_acl(self, method: str, path: str, body_fn, acl, token: str):
        """ACL endpoints (nomad/acl_endpoint.go): bootstrap once without
        a token; token/self with any valid token; everything else needs
        a management token."""
        s = self.server
        store = s.store
        idx = store.latest_index()

        if path == "/v1/acl/bootstrap" and method in ("PUT", "POST"):
            tok = s.bootstrap_acl()
            return to_wire(tok), store.latest_index()

        if path == "/v1/acl/token/self" and method == "GET":
            tok = store.acl_token_by_secret(token) if token else None
            if tok is None:
                raise PermissionError("ACL token not found")
            return to_wire(tok), idx

        if s.config.acl_enabled and not acl.is_management():
            raise PermissionError("Permission denied")

        from ..acl import AclPolicy
        if path == "/v1/acl/policies" and method == "GET":
            return [{"name": p.name, "description": p.description,
                     "modify_index": p.modify_index}
                    for p in store.acl_policies()], idx
        m = re.match(r"^/v1/acl/policy/([^/]+)$", path)
        if m:
            name = m.group(1)
            if method == "GET":
                p = store.acl_policy(name)
                return (to_wire(p), idx) if p else None
            if method in ("PUT", "POST"):
                data = body_fn()
                p = AclPolicy(name=name,
                              description=data.get("description", ""),
                              rules=data.get("rules", ""))
                s.upsert_acl_policies([p])
                return {"ok": True}, store.latest_index()
            if method == "DELETE":
                s.delete_acl_policies([name])
                return {"ok": True}, store.latest_index()
        if path == "/v1/acl/tokens" and method == "GET":
            return [t.stub() for t in store.acl_tokens()], idx
        if path == "/v1/acl/token" and method in ("PUT", "POST"):
            data = body_fn()
            tok = s.create_acl_token(
                name=data.get("name", ""),
                type_=data.get("type", "client"),
                policies=data.get("policies") or [],
                global_=bool(data.get("global", False)))
            return to_wire(tok), store.latest_index()
        m = re.match(r"^/v1/acl/token/([^/]+)$", path)
        if m:
            accessor = m.group(1)
            if method == "GET":
                tok = store.acl_token_by_accessor(accessor)
                return (to_wire(tok), idx) if tok else None
            if method == "DELETE":
                s.delete_acl_tokens([accessor])
                return {"ok": True}, store.latest_index()
        return None

    def _admit_write(self, body_fn=None) -> None:
        """The single write-path admission hook:
        every eval-creating write — register, bulk register, dispatch,
        evaluate, periodic force — funnels through here instead of
        copy-pasting the broker valve per route. Order matters: the
        ingest gateway's queue watermark sheds FIRST, before the body
        is decoded (the hint rides Content-Length via
        body_fn.hint_bytes), then the broker's delayed-heap valve runs.
        Both raise AdmissionOverloadError -> 429 + Retry-After."""
        s = self.server
        ing = getattr(s, "ingest", None)
        if ing is not None:
            ing.check_admission(
                int(getattr(body_fn, "hint_bytes", 0) or 0))
        s.eval_broker.check_register_admission()

    def _register_jobs_bulk(self, items: list) -> list:
        """Array-body `PUT /v1/jobs`: each element is the same
        envelope the single register takes ({"Job": ...} / {"job": ...}
        / bare spec / HCL string). Specs decode through the dedup pool
        (a storm of near-identical jobs materializes shared subtrees
        once), then the whole admitted run parks on the ingest gateway
        as one batch. A bad item fails ONLY its own slot; EnforceIndex
        CAS is a per-job serialization concern the coalesced path
        cannot honor, so those items error individually."""
        from ..state.columnar import WirePool, from_wire_pooled
        pool = WirePool()
        jobs = []               # parallel to items: Job | Exception
        for data in items:
            try:
                if not isinstance(data, dict):
                    raise ValueError(
                        "bulk register items must be objects")
                if data.get("EnforceIndex"):
                    raise ValueError(
                        "EnforceIndex is not supported in bulk "
                        "register; submit CAS registers individually")
                spec = data.get("Job", data.get("job", data))
                jobs.append(from_wire_pooled(Job, spec, pool)
                            if isinstance(spec, dict)
                            else parse_job(spec))
            except (ValueError, KeyError, TypeError) as e:
                jobs.append(e)
        results = iter(self.server.register_jobs_bulk(
            [j for j in jobs if not isinstance(j, Exception)]))
        out = []
        for j in jobs:
            r = j if isinstance(j, Exception) else next(results)
            if isinstance(r, Exception):
                out.append({"Error": str(r)})
            else:
                out.append({"EvalID": r.id if r is not None else "",
                            "JobModifyIndex": j.job_modify_index
                            or j.modify_index})
        return out

    def _route_main(self, method: str, path: str, q: dict, body_fn,
                    ns: str, idx: int, acl=None):
        s = self.server
        store = s.store

        if path == "/v1/jobs":
            if method == "GET":
                prefix = q.get("prefix", "")
                jobs = [self._job_stub(j) for j in store.jobs(ns)
                        if j.id.startswith(prefix)]
                return jobs, idx
            if method in ("PUT", "POST"):
                # backpressure escalation: refuse NEW work at the edge
                # while the ingest queue or the broker's delayed heap
                # is over watermark (429 + Retry-After) — before the
                # body is decoded; internal requeues and
                # already-admitted evals are never refused
                self._admit_write(body_fn)
                data = body_fn()
                if isinstance(data, list):
                    # array body = bulk register: the whole
                    # batch parks on the ingest gateway and lands as
                    # one raft entry; per-item results in order
                    return self._register_jobs_bulk(data), \
                        store.latest_index()
                spec = data.get("Job", data.get("job", data))
                job = from_wire(Job, spec) if isinstance(spec, dict) \
                    else parse_job(spec)
                # `job run -check-index` CAS (job_endpoint.go Register
                # EnforceIndex + JobModifyIndex)
                ev = s.register_job(
                    job,
                    enforce_index=bool(data.get("EnforceIndex")),
                    job_modify_index=int(data.get("JobModifyIndex")
                                         or 0))
                # periodic/parameterized registrations create no eval
                return {"EvalID": ev.id if ev is not None else "",
                        "JobModifyIndex": job.job_modify_index
                        or job.modify_index}, \
                    store.latest_index()

        if path == "/v1/jobs/parse" and method in ("PUT", "POST"):
            data = body_fn()
            job = parse_job(data.get("JobHCL", ""))
            return to_wire(job), idx

        m = re.match(r"^/v1/job/([^/]+)$", path)
        if m:
            job_id = m.group(1)
            if method == "GET":
                job = store.job_by_id(ns, job_id)
                if job is None:
                    return None
                return to_wire(job), idx
            if method == "DELETE":
                purge = q.get("purge", "").lower() == "true"
                if q.get("global", "").lower() == "true":
                    # multiregion stop fans to every region in the
                    # job's multiregion block (nomad job stop -global)
                    ev = s.deregister_job_global(ns, job_id, purge=purge)
                else:
                    ev = s.deregister_job(ns, job_id, purge=purge)
                return {"EvalID": ev.id}, store.latest_index()

        m = re.match(r"^/v1/job/([^/]+)/(\w+)$", path)
        if m:
            job_id, sub = m.group(1), m.group(2)
            if sub == "allocations":
                return [a.stub() for a in store.allocs_by_job(ns, job_id)], idx
            if sub == "evaluations":
                return [e.stub() for e in store.evals_by_job(ns, job_id)], idx
            if sub == "summary":
                summ = store.job_summary(ns, job_id)
                return (to_wire(summ), idx) if summ else None
            if sub == "versions":
                return [to_wire(j) for j in store.job_versions(ns, job_id)], idx
            if sub == "deployments":
                return [to_wire(d)
                        for d in store.deployments_by_job(ns, job_id)], idx
            if sub == "dispatch" and method in ("PUT", "POST"):
                # same edge valve as job register: parameterized
                # dispatch is the designed high-volume eval creator
                self._admit_write(body_fn)
                import base64 as _b64
                data = body_fn()
                payload = data.get("Payload") or data.get("payload") or ""
                ev = s.dispatch_job(
                    ns, job_id,
                    payload=_b64.b64decode(payload) if payload else b"",
                    meta=data.get("Meta") or data.get("meta") or {})
                return {"DispatchedJobID": ev.job_id,
                        "EvalID": ev.id}, store.latest_index()
            if sub == "evaluate" and method in ("PUT", "POST"):
                # force a fresh evaluation (job_endpoint.go Evaluate)
                self._admit_write(body_fn)
                ev = s.evaluate_job(ns, job_id)
                return {"EvalID": ev.id}, store.latest_index()
            if sub == "scaling-events":
                return {"ScalingEvents":
                        store.scaling_events(ns, job_id)}, idx

        m = re.match(r"^/v1/job/([^/]+)/periodic/force$", path)
        if m and method in ("PUT", "POST"):
            # launch a periodic job's child NOW (periodic_endpoint.go)
            self._admit_write(body_fn)
            ev = s.periodic.force_run(ns, m.group(1))
            if ev is None:
                return {"EvalID": "", "Skipped": True}, \
                    store.latest_index()
            return {"EvalID": ev.id,
                    "DispatchedJobID": ev.job_id}, store.latest_index()

        if path == "/v1/operator/members" and method == "GET":
            # the replicated voter set (agent_endpoint.go Members /
            # serf members, minus gossip metadata)
            raft = getattr(s, "raft", None)
            return {"Members": store.server_members(),
                    "Leader": raft.leader_addr if raft else "",
                    "ClusterSize": raft.cluster_size if raft else 1}, idx

        if path == "/v1/agent/members" and method == "GET":
            # scheduler-plane member view: the voter set
            # annotated with raft role, applied index, fence lag and
            # per-follower leased evals — the data `nomad server
            # members` renders and `operator debug` bundles
            raft = getattr(s, "raft", None)
            return {"Members": store.server_members(),
                    "Leader": raft.leader_addr if raft else "",
                    "ClusterSize": raft.cluster_size if raft else 1,
                    "SchedulerPlane": s.scheduler_plane_status()}, idx

        # durable event sinks (nomad/stream/sink.go CRUD)
        if path == "/v1/event/sinks" and method == "GET":
            return [sk.stub() for sk in store.event_sinks()], idx
        if path == "/v1/event/sink" and method in ("PUT", "POST"):
            from ..server.event_sink import EventSink
            from ..utils.ids import generate_uuid
            data = body_fn()
            sink = EventSink(
                id=data.get("ID") or data.get("id") or generate_uuid(),
                type=data.get("Type") or data.get("type") or "webhook",
                address=data.get("Address") or data.get("address") or "",
                topics=data.get("Topics") or data.get("topics") or {},
                latest_index=int(data.get("LatestIndex")
                                 or data.get("latest_index") or 0))
            if not sink.address:
                raise ValueError("event sink requires an address")
            from ..server.event_sink import SINK_WEBHOOK
            if sink.type != SINK_WEBHOOK:
                raise ValueError(
                    f"unsupported sink type {sink.type!r}; "
                    f"supported: {SINK_WEBHOOK}")
            # a malformed topics filter must be rejected here — a
            # non-dict filter raises inside the broker's publish loop
            # and would break delivery for every OTHER subscriber
            if not isinstance(sink.topics, dict) or not all(
                    isinstance(k, str) and isinstance(v, (list, tuple))
                    and all(isinstance(x, str) for x in v)
                    for k, v in sink.topics.items()):
                raise ValueError(
                    "Topics must map topic names to lists of keys")
            s.upsert_event_sink(sink)
            return {"ID": sink.id}, store.latest_index()
        m = re.match(r"^/v1/event/sink/([^/]+)$", path)
        if m:
            if method == "GET":
                sink = store.event_sink(m.group(1))
                return (sink.stub(), idx) if sink else None
            if method == "DELETE":
                s.delete_event_sink(m.group(1))
                return {}, store.latest_index()

        # autoscaling API: the external autoscaler's read surface
        # (nomad/scaling_endpoint.go:24 ListPolicies, :90 GetPolicy)
        if path == "/v1/scaling/policies" and method == "GET":
            pols = store.scaling_policies(
                namespace=ns, job_id=q.get("job") or None,
                policy_type=q.get("type") or None)
            return [p.stub() for p in pols], idx

        m = re.match(r"^/v1/scaling/policy/([^/]+)$", path)
        if m and method == "GET":
            pol = store.scaling_policy_by_id(m.group(1))
            if pol is None:
                return None
            return to_wire(pol), idx

        # namespaces (nomad/namespace_endpoint.go — the list is
        # filtered to namespaces the token can read)
        if path == "/v1/namespaces" and method == "GET":
            out = [to_wire(n) for n in store.namespaces()
                   if acl is None or not s.config.acl_enabled
                   or acl.is_management() or acl.allow_operator_read()
                   or acl.allow_namespace(n.name)]
            return out, idx

        m = re.match(r"^/v1/namespace/([^/]+)$", path)
        if m:
            name = m.group(1)
            if method == "GET":
                got = store.namespace_by_name(name)
                return (to_wire(got), idx) if got else None
            if method in ("PUT", "POST"):
                from ..models.namespace import Namespace
                data = body_fn() or {}
                ns_obj = Namespace(
                    name=data.get("name", name) or name,
                    description=data.get("description", ""),
                    meta=dict(data.get("meta") or {}))
                s.upsert_namespaces([ns_obj])
                return {"ok": True}, store.latest_index()
            if method == "DELETE":
                s.delete_namespaces([name])
                return {"ok": True}, store.latest_index()

        # built-in service catalog (nomad service list/info; the
        # reference's equivalent discovery surface lives in Consul)
        if path == "/v1/services" and method == "GET":
            return s.list_services(namespace=ns), idx

        m = re.match(r"^/v1/service/([^/]+)$", path)
        if m and method == "GET":
            regs = s.get_service(ns, m.group(1))
            if not regs:
                return None
            return [to_wire(r) for r in regs], idx

        m = re.match(r"^/v1/service/([^/]+)/([^/]+)$", path)
        if m and method == "DELETE":
            # the id must belong to the named service in the token's
            # namespace — a bare id would let a caller deregister
            # across namespace boundaries
            name, rid = m.group(1), m.group(2)
            if not any(r.id == rid
                       for r in store.service_by_name(ns, name)):
                return None
            s.update_service_registrations(delete_ids=[rid])
            return {}, idx

        if path == "/v1/nodes" and method == "GET":
            prefix = q.get("prefix", "")
            return [n.stub() for n in store.nodes()
                    if n.id.startswith(prefix)], idx

        m = re.match(r"^/v1/node/([^/]+)$", path)
        if m and method == "GET":
            node = self._find_node(m.group(1))
            if node is None:
                return None
            return to_wire(node), idx

        m = re.match(r"^/v1/node/([^/]+)/(\w+)$", path)
        if m:
            node = self._find_node(m.group(1))
            if node is None:
                return None
            sub = m.group(2)
            if sub == "allocations" and method == "GET":
                return [a.stub() for a in store.allocs_by_node(node.id)], idx
            if sub == "eligibility" and method in ("PUT", "POST"):
                data = body_fn()
                elig = data.get("Eligibility", "")
                if elig not in (NODE_SCHED_ELIGIBLE, NODE_SCHED_INELIGIBLE):
                    raise ValueError(f"invalid eligibility {elig}")
                s.raft_apply("node_eligibility_update",
                             dict(node_id=node.id, eligibility=elig))
                return {"NodeModifyIndex": store.latest_index()}, \
                    store.latest_index()
            if sub == "drain" and method in ("PUT", "POST"):
                data = body_fn()
                spec = data.get("DrainSpec")
                strategy = None
                if spec:
                    strategy = DrainStrategy(drain_spec=DrainSpec(
                        deadline_s=parse_duration_s(spec.get("Deadline"), 0.0),
                        ignore_system_jobs=bool(
                            spec.get("IgnoreSystemJobs", False))))
                s.update_node_drain(node.id, strategy,
                                    data.get("MarkEligible", False))
                return {"NodeModifyIndex": store.latest_index()}, \
                    store.latest_index()

        if path == "/v1/allocations" and method == "GET":
            prefix = q.get("prefix", "")
            return [a.stub() for a in store.allocs()
                    if a.id.startswith(prefix)], idx

        m = re.match(r"^/v1/allocation/([^/]+)/stop$", path)
        if m and method in ("PUT", "POST"):
            alloc = self._alloc_in_ns(m.group(1), ns)
            if alloc is None:
                return None
            ev = s.stop_alloc(alloc.id)
            return {"EvalID": ev.id}, store.latest_index()

        m = re.match(r"^/v1/allocation/([^/]+)$", path)
        if m and method == "GET":
            alloc = self._unique_prefix(store.allocs(), m.group(1), "allocation")
            if alloc is None:
                return None
            return to_wire(alloc), idx

        if path == "/v1/deployments" and method == "GET":
            prefix = q.get("prefix", "")
            return [to_wire(d) for d in store.deployments()
                    if d.id.startswith(prefix)], idx

        m = re.match(r"^/v1/deployment/([^/]+)/([^/]+)$", path)
        if m:
            action = m.group(1)
            d = self._unique_prefix(store.deployments(), m.group(2),
                                    "deployment")
            if d is None:
                return None
            if action == "allocations" and method == "GET":
                return [a.stub()
                        for a in store.allocs_by_deployment(d.id)], idx
            if method in ("PUT", "POST"):
                if action == "promote":
                    data = body_fn()
                    groups = data.get("Groups")
                    ev = s.promote_deployment(d.id, groups)
                    return {"EvalID": ev.id}, store.latest_index()
                if action == "fail":
                    ev = s.fail_deployment(d.id)
                    return {"EvalID": ev.id if ev else ""}, store.latest_index()
                if action == "pause":
                    data = body_fn()
                    s.pause_deployment(d.id, bool(data.get("Pause", False)))
                    return {"DeploymentModifyIndex": store.latest_index()}, \
                        store.latest_index()

        m = re.match(r"^/v1/deployment/([^/]+)$", path)
        if m and method == "GET":
            d = self._unique_prefix(store.deployments(), m.group(1),
                                    "deployment")
            if d is None:
                return None
            return to_wire(d), idx

        m = re.match(r"^/v1/job/([^/]+)/revert$", path)
        if m and method in ("PUT", "POST"):
            data = body_fn()
            ev = s.revert_job(ns, m.group(1),
                              int(data.get("JobVersion", 0)))
            return {"EvalID": ev.id if ev else ""}, store.latest_index()

        m = re.match(r"^/v1/job/([^/]+)/plan$", path)
        if m and method in ("PUT", "POST"):
            data = body_fn()
            spec = data.get("Job", data)
            job = from_wire(Job, spec) if isinstance(spec, dict) \
                else parse_job(spec)
            result = s.plan_job(job, diff=bool(data.get("Diff", True)))
            return result, idx

        m = re.match(r"^/v1/job/([^/]+)/scale$", path)
        if m:
            job_id = m.group(1)
            if method == "GET":
                job = store.job_by_id(ns, job_id)
                if job is None:
                    return None
                summ = store.job_summary(ns, job_id)
                return {
                    "JobID": job.id, "JobStopped": job.stopped(),
                    "TaskGroups": {
                        tg.name: {"Desired": tg.count,
                                  **(summ.summary.get(tg.name, {})
                                     if summ else {})}
                        for tg in job.task_groups},
                    "ScalingEvents": store.scaling_events(ns, job_id),
                }, idx
            if method in ("PUT", "POST"):
                data = body_fn()
                target = data.get("Target", {})
                ev = s.scale_job(
                    ns, job_id, target.get("Group", ""),
                    count=data.get("Count"),
                    message=data.get("Message", ""),
                    error=bool(data.get("Error", False)))
                return {"EvalID": ev.id if ev else ""}, store.latest_index()

        if path == "/v1/evaluations" and method == "GET":
            return [e.stub() for e in store.evals()], idx

        m = re.match(r"^/v1/evaluation/([^/]+)$", path)
        if m and method == "GET":
            ev = self._unique_prefix(store.evals(), m.group(1), "evaluation")
            if ev is None:
                return None
            return to_wire(ev), idx

        # operator snapshot (nomad operator snapshot save/restore;
        # nomad/operator_endpoint.go SnapshotSave): the full store dump.
        # Restore is allowed only outside raft mode — reseeding one
        # server's FSM under a live replicated log would desync
        # followers (they reseed via raft snapshot install instead).
        if path == "/v1/operator/snapshot":
            if method == "GET":
                snap = store.snapshot()
                return {"index": snap.latest_index(),
                        "snapshot": snap.dump()}, idx
            if method in ("PUT", "POST"):
                if getattr(s, "raft", None) is not None:
                    raise ValueError(
                        "snapshot restore over HTTP is only supported "
                        "on single-server (dev) mode; clustered "
                        "servers reseed via raft")
                data = body_fn() or {}
                payload = data.get("snapshot")
                if not isinstance(payload, dict):
                    raise ValueError("missing snapshot body")
                s.install_snapshot(payload)
                return {"index": store.latest_index()}, \
                    store.latest_index()

        # steady-state governor status (governor/): registered gauges
        # with watermark state, backpressure, and the structured event
        # log (watermark crossings, reclaims, drift findings)
        if path == "/v1/operator/governor" and method == "GET":
            gov = getattr(s, "governor", None)
            if gov is None:
                return {"enabled": False}, idx
            return gov.status(), idx

        # retained telemetry: the in-process history ring —
        # chronological gauge/counter/stage/device series plus derived
        # rates; ?n= limits to the most recent N samples. `nomad
        # operator top` renders trends from this instead of a single
        # snapshot
        if path == "/v1/operator/telemetry" and method == "GET":
            tel = getattr(s, "telemetry", None)
            if tel is None:
                return {"enabled": False}, idx
            last = max(0, min(int(q.get("n", 0) or 0), 100000))
            out = tel.status()
            out.update(tel.history(last=last or None))
            return out, idx

        # live flatness verdict: bench/soak.flatness_verdict
        # — the soak artifact's pass/fail math — run over the live
        # telemetry ring, so an operator (or the validation campaign)
        # reads steady-state health without a post-hoc harness
        if path == "/v1/operator/flatness" and method == "GET":
            tel = getattr(s, "telemetry", None)
            if tel is None:
                return {"enabled": False, "pass": None}, idx
            out = tel.flatness()
            out["enabled"] = True
            return out, idx

        # operator autopilot configuration (nomad/operator_endpoint.go
        # AutopilotGetConfiguration / AutopilotSetConfiguration)
        if path == "/v1/operator/autopilot/configuration":
            if method == "GET":
                return {"CleanupDeadServers":
                        s.config.dead_server_cleanup_s > 0,
                        "DeadServerCleanupSecs":
                        s.config.dead_server_cleanup_s}, idx
            if method in ("PUT", "POST"):
                data = body_fn() or {}
                if "DeadServerCleanupSecs" in data:
                    s.config.dead_server_cleanup_s = float(
                        data["DeadServerCleanupSecs"])
                elif data.get("CleanupDeadServers") is False:
                    s.config.dead_server_cleanup_s = 0.0
                elif data.get("CleanupDeadServers") is True and \
                        s.config.dead_server_cleanup_s <= 0:
                    s.config.dead_server_cleanup_s = 30.0  # default
                return {"Updated": True}, idx

        if path == "/v1/search" and method in ("PUT", "POST"):
            data = body_fn()
            return self._search(data.get("Prefix", ""),
                                data.get("Context", "all"), ns), idx

        if path == "/v1/status/leader":
            # status_endpoint.go Leader: the raft leader's RPC address;
            # mid-election there IS no leader and saying otherwise would
            # route leader-only traffic at a candidate
            raft = getattr(s, "raft", None)
            if raft is not None:
                if not raft.leader_addr:
                    raise RuntimeError("No cluster leader")
                return raft.leader_addr, idx
            rpc = getattr(s, "rpc_server", None)
            return (rpc.addr if rpc is not None else "127.0.0.1:4647"), idx

        m = re.match(r"^/v1/client/fs/(logs|ls|cat|stream)/([^/]+)$", path)
        if m and method == "GET":
            return self._client_fs(m.group(1), m.group(2), q, ns, idx)

        # client host stats (command/agent/stats_endpoint.go
        # — the server proxies to the owning client by node lookup,
        # nomad/client_stats_endpoint.go). ?node_id= picks the node; a
        # single-node cluster (the dev agent) defaults to it
        if path == "/v1/client/stats" and method == "GET":
            node = None
            if q.get("node_id"):
                node = self._find_node(q["node_id"])
                if node is None:
                    return None
            else:
                nodes = s.store.nodes()
                if len(nodes) == 1:
                    node = nodes[0]
                else:
                    raise ValueError(
                        "node_id parameter required on a multi-node "
                        "cluster")
            args = {}
            if q.get("history", "").lower() in ("1", "true"):
                args = {"history": True,
                        "n": max(0, int(q.get("n", 0) or 0))}
            return self._forward_node(node.id, "ClientStats.Host",
                                      args), idx

        # per-alloc ResourceUsage (client/alloc_endpoint.go Stats):
        # live task-level usage from the owning client's sampler
        m = re.match(r"^/v1/client/allocation/([^/]+)/stats$", path)
        if m and method == "GET":
            alloc = self._alloc_in_ns(m.group(1), ns)
            if alloc is None:
                return None
            return self._forward_client(alloc, "ClientStats.Alloc",
                                        {}), idx

        # alloc exec sessions (client/alloc_endpoint.go:163): start
        # returns a session id; io round-trips stdin/stdout frames
        m = re.match(r"^/v1/client/allocation/([^/]+)/(restart|signal)$",
                     path)
        if m and method in ("PUT", "POST"):
            alloc = self._alloc_in_ns(m.group(1), ns)
            if alloc is None:
                return None
            data = body_fn()
            args = {"task": data.get("Task") or data.get("task") or ""}
            if m.group(2) == "signal":
                args["signal"] = data.get("Signal") or data.get("signal")
            out = self._forward_client(
                alloc, "ClientAlloc.Restart" if m.group(2) == "restart"
                else "ClientAlloc.Signal", args)
            return out, idx

        m = re.match(r"^/v1/client/allocation/([^/]+)/exec$", path)
        if m and method in ("PUT", "POST"):
            return self._client_exec_start(m.group(1), body_fn(), ns, idx)
        m = re.match(r"^/v1/client/allocation/([^/]+)/exec/([^/]+)$", path)
        if m:
            if method in ("PUT", "POST"):
                return self._client_exec_io(m.group(1), m.group(2),
                                            body_fn(), ns, idx)
            if method == "DELETE":
                alloc = self._alloc_in_ns(m.group(1), ns)
                if alloc is None:
                    return None
                self._forward_client(alloc, "ClientExec.Stop",
                                     {"session_id": m.group(2)})
                return {}, idx

        if path == "/v1/volumes" and method == "GET":
            vols = store.csi_volumes(ns)
            return [v.stub() for v in vols], idx

        m = re.match(r"^/v1/volume/csi/([^/]+)$", path)
        if m:
            vol_id = m.group(1)
            if method == "GET":
                v = store.csi_volume(ns, vol_id)
                return (to_wire(v), idx) if v else None
            if method in ("PUT", "POST"):
                from ..models.csi import CSIVolume
                data = body_fn()
                spec = data.get("Volume", data.get("volume", data))
                vol = from_wire(CSIVolume, spec)
                vol.id = vol.id or vol_id
                vol.namespace = vol.namespace or ns
                s.register_csi_volume(vol)
                return {"ok": True}, store.latest_index()
            if method == "DELETE":
                s.deregister_csi_volume(
                    ns, vol_id, force=q.get("force", "") == "true")
                return {"ok": True}, store.latest_index()

        if path == "/v1/agent/self":
            return {"member": {"Name": "server", "Status": "alive"},
                    "stats": {"broker": self.server.eval_broker.stats.as_dict()},
                    "config": {"NumSchedulers":
                               self.server.config.num_schedulers}}, idx

        if path == "/v1/metrics" and method == "GET":
            from ..utils import metrics
            # ?format=prometheus: text exposition (histogram buckets +
            # counters + gauges) for a scrape config pointed straight
            # at the agent
            if q.get("format", "") == "prometheus":
                return PlainText(metrics.prometheus()), idx
            return metrics.snapshot(), idx

        if path == "/v1/agent/pprof/cmdline" and method == "GET":
            import sys as _sys
            return {"cmdline": list(_sys.argv)}, idx

        if path == "/v1/agent/pprof/profile" and method == "GET":
            # agent_endpoint.go:339 — CPU profile for ?seconds=N; the
            # Python analog runs cProfile over the window and returns
            # the cumulative-sorted pstats report
            import cProfile
            import io as _io
            import pstats
            import time as _time
            seconds = min(float(q.get("seconds", 1)), 30.0)
            pr = cProfile.Profile()
            pr.enable()
            _time.sleep(seconds)
            pr.disable()
            out = _io.StringIO()
            pstats.Stats(pr, stream=out).sort_stats("cumulative") \
                .print_stats(50)
            return {"profile": out.getvalue(), "seconds": seconds}, idx

        if path == "/v1/agent/pprof/threads" and method == "GET":
            # goroutine-dump analog: all python thread stacks
            import sys as _sys
            import traceback as _tb
            frames = _sys._current_frames()
            import threading as _threading
            names = {t.ident: t.name for t in _threading.enumerate()}
            dump = {}
            for tid, frame in frames.items():
                dump[names.get(tid, str(tid))] = \
                    "".join(_tb.format_stack(frame))
            return {"threads": dump}, idx

        if path == "/v1/operator/raft/configuration" and method == "GET":
            raft = getattr(s, "raft", None)
            if raft is None:
                return {"Servers": [{"Address": "in-process",
                                     "Leader": True, "Term": 0}],
                        "Index": idx}, idx
            with raft._lock:
                servers = [{"Address": raft.self_addr,
                            "Role": raft.role,
                            "Leader": raft.is_leader(),
                            "Term": raft.term,
                            "LastLogIndex": raft.last_log()[0]}]
                for p in raft.peers:
                    servers.append({"Address": p,
                                    "Leader": p == raft.leader_addr})
            return {"Servers": servers, "Index": idx}, idx

        if path == "/v1/system/gc" and method in ("PUT", "POST"):
            s.force_gc()
            return {"ok": True}, idx

        if path == "/v1/operator/scheduler/configuration":
            if method == "GET":
                return {"SchedulerConfig":
                        to_wire(store.scheduler_config())}, idx
            if method in ("PUT", "POST"):
                data = body_fn()
                from ..models import SchedulerConfiguration
                cfg = from_wire(SchedulerConfiguration,
                                data.get("SchedulerConfig", data))
                self.server.raft_apply("scheduler_config", dict(config=cfg))
                return {"Updated": True}, store.latest_index()

        return None

    # -- search (nomad/search_endpoint.go: prefix search, 20-match cap) --
    TRUNCATE_LIMIT = 20

    def _search(self, prefix: str, context: str, ns: str) -> dict:
        store = self.server.store
        sources = {
            "jobs": lambda: [j.id for j in store.jobs(ns)],
            "nodes": lambda: [n.id for n in store.nodes()],
            "allocs": lambda: [a.id for a in store.allocs()],
            "evals": lambda: [e.id for e in store.evals()],
            "deployment": lambda: [d.id for d in store.deployments()],
        }
        if context != "all":
            if context not in sources:
                raise ValueError(f"invalid search context {context!r}")
            sources = {context: sources[context]}
        matches, truncations = {}, {}
        for name, fn in sources.items():
            ids = sorted(i for i in fn() if i.startswith(prefix))
            truncations[name] = len(ids) > self.TRUNCATE_LIMIT
            matches[name] = ids[:self.TRUNCATE_LIMIT]
        return {"Matches": matches, "Truncations": truncations}

    # -- event stream (nomad/stream/ndjson.go over chunked HTTP) --------
    def _alloc_base(self, alloc_id: str) -> Optional[str]:
        for base in self.alloc_dir_bases:
            p = os.path.join(base, alloc_id)
            if os.path.isdir(p):
                return p
        return None

    def _alloc_in_ns(self, alloc_prefix: str, ns: str):
        return self._unique_prefix(
            [a for a in self.server.store.allocs() if a.namespace == ns],
            alloc_prefix, "allocation")

    def _forward_node(self, node_id: str, method: str, args: dict):
        """Forward a request to a client's RPC listener by NODE lookup
        (nomad/client_fs_endpoint.go, client_stats_endpoint.go: the
        client advertises its address on the Node record). Connections
        are cached per node."""
        node = self.server.store.node_by_id(node_id)
        addr = node.attributes.get("nomad.client.rpc") if node else None
        if not addr:
            raise KeyError(
                f"node {node_id[:8]} has no reachable client RPC "
                "address")
        from ..rpc.client import RpcClient
        cache = getattr(self, "_client_rpc_cache", None)
        if cache is None:
            cache = self._client_rpc_cache = {}
        # keyed by node id: a restarted client re-advertises on a new
        # ephemeral port, and the stale connection must be closed and
        # replaced instead of accumulating per historical address
        hit = cache.get(node_id)
        if hit is None or hit[0] != addr:
            if hit is not None:
                try:
                    hit[1].close()
                except Exception:
                    pass
            hit = (addr, RpcClient(addr, dial_timeout_s=2.0))
            cache[node_id] = hit
        return hit[1].call(method, args, timeout_s=60.0)

    def _forward_client(self, alloc, method: str, args: dict):
        """Forward a logs/fs/exec/stats request to the client OWNING
        the alloc (servers proxy these to the node)."""
        args = dict(args)
        args["alloc_id"] = alloc.id
        return self._forward_node(alloc.node_id, method, args)

    def _default_task(self, alloc, task: str) -> str:
        if task:
            return task
        tg = alloc.job.lookup_task_group(alloc.task_group) \
            if alloc.job else None
        if tg and len(tg.tasks) == 1:
            return tg.tasks[0].name
        raise ValueError("task parameter required")

    def _client_fs(self, op: str, alloc_prefix: str, q: dict, ns: str,
                   idx: int):
        """/v1/client/fs/{logs,ls,cat,stream} (client/fs_endpoint.go):
        serve an alloc's log files and directory tree — from the local
        alloc dir when co-located, else forwarded to the owning client
        over RPC. The alloc must live in the request's (ACL-checked)
        namespace."""
        import base64

        from ..client import fs_service
        alloc = self._alloc_in_ns(alloc_prefix, ns)
        if alloc is None:
            return None
        base = self._alloc_base(alloc.id)
        offset = int(q.get("offset", 0))
        if op == "logs":
            task = self._default_task(alloc, q.get("task", ""))
            stream = q.get("type", "stdout")
            if base is not None:
                data, total = fs_service.read_logs(base, task, stream,
                                                   offset)
            else:
                r = self._forward_client(
                    alloc, "ClientFS.Logs",
                    {"task": task, "type": stream, "offset": offset})
                data, total = bytes(r.get("Data") or b""), r["Offset"]
            return {"Data": data.decode("utf-8", "replace"),
                    "Offset": total}, idx
        if op == "stream":
            log_type = q.get("log_type", "")
            task = self._default_task(alloc, q.get("task", "")) \
                if log_type else q.get("task", "")
            wait_s = min(float(q.get("wait_s", 0.0)), 30.0)
            if base is not None:
                frames = fs_service.stream_frames(
                    base, q.get("path"), offset, task=task,
                    log_type=log_type, wait_s=wait_s)
            else:
                r = self._forward_client(
                    alloc, "ClientFS.Stream",
                    {"path": q.get("path"), "offset": offset,
                     "task": task, "log_type": log_type,
                     "wait_s": wait_s})
                frames = r["Frames"]
            out = []
            for f in frames:
                f = dict(f)
                f["Data"] = base64.b64encode(
                    bytes(f.get("Data") or b"")).decode()
                out.append(f)
            return {"Frames": out}, idx
        rel = q.get("path", "/")
        if op == "ls":
            if base is not None:
                entries = fs_service.list_dir(base, rel)
            else:
                entries = self._forward_client(
                    alloc, "ClientFS.List", {"path": rel})["Entries"]
            return (entries, idx) if entries is not None else None
        # cat
        if base is not None:
            data = fs_service.cat_file(base, rel)
        else:
            data = self._forward_client(
                alloc, "ClientFS.Cat", {"path": rel})["Data"]
        if data is None:
            return None
        return {"Data": bytes(data).decode("utf-8", "replace")}, idx

    def _client_exec_start(self, alloc_prefix: str, body: dict, ns: str,
                           idx: int):
        """POST /v1/client/allocation/:alloc/exec — start a command in
        the task environment (AllocExecRequest,
        client/alloc_endpoint.go:163). Always routed through the
        owning client's RPC listener (co-located included) so one code
        path serves every topology."""
        alloc = self._alloc_in_ns(alloc_prefix, ns)
        if alloc is None:
            return None
        task = self._default_task(alloc, body.get("Task")
                                  or body.get("task") or "")
        cmd = body.get("Cmd") or body.get("cmd") or []
        r = self._forward_client(alloc, "ClientExec.Start",
                                 {"task": task, "cmd": list(cmd)})
        return {"SessionID": r["session_id"]}, idx

    def _client_exec_io(self, alloc_prefix: str, sid: str, body: dict,
                        ns: str, idx: int):
        import base64
        alloc = self._alloc_in_ns(alloc_prefix, ns)
        if alloc is None:
            return None
        stdin_b64 = body.get("Stdin") or body.get("stdin") or ""
        args = {"session_id": sid,
                "stdin": base64.b64decode(stdin_b64) if stdin_b64 else b"",
                "close_stdin": bool(body.get("CloseStdin")
                                    or body.get("close_stdin")),
                "wait_s": min(float(body.get("WaitS")
                                    or body.get("wait_s") or 0.0), 30.0)}
        sig = body.get("Signal") or body.get("signal")
        if sig:
            args["signal"] = int(sig)
        r = self._forward_client(alloc, "ClientExec.Io", args)
        return {"Stdout": base64.b64encode(
                    bytes(r.get("stdout") or b"")).decode(),
                "Stderr": base64.b64encode(
                    bytes(r.get("stderr") or b"")).decode(),
                "Exited": bool(r.get("exited")),
                "ExitCode": int(r.get("exit_code", -1))}, idx

    def stream_monitor(self, handler, q: dict):
        """/v1/agent/monitor (agent_endpoint.go monitor): stream agent
        log lines as NDJSON at >= log_level."""
        from ..utils.monitor import get_buffer, parse_level
        buf = get_buffer()
        level = parse_level(q.get("log_level", "info"))
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Transfer-Encoding", "chunked")
            handler.end_headers()

            def write_chunk(data: bytes):
                _write_chunk(handler.wfile, data)

            seq = 0
            while True:
                seq, lines = buf.read_since(seq, level, timeout_s=5.0)
                if not lines:
                    write_chunk(b"{}\n")            # keepalive
                    continue
                for line in lines:
                    write_chunk((json.dumps({"Data": line}) + "\n")
                                .encode())
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # client went away

    def stream_events(self, handler, raw_topics, from_index: int):
        from ..server.event_broker import ALL_KEYS, TOPIC_ALL
        from ..utils.codec import to_wire
        topics = {}
        for t in raw_topics:
            topic, _, key = t.partition(":")
            topics.setdefault(topic or TOPIC_ALL, []).append(key or ALL_KEYS)
        sub, backlog = self.server.events.subscribe(
            topics or None, from_index)
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Transfer-Encoding", "chunked")
            handler.end_headers()

            def write_chunk(data: bytes):
                _write_chunk(handler.wfile, data)

            def emit(events):
                if not events:
                    write_chunk(b"{}\n")  # heartbeat (ndjson.go keepalive)
                    return
                payload = {"Index": max(e.index for e in events),
                           "Events": [to_wire(e) for e in events]}
                write_chunk((json.dumps(payload) + "\n").encode())

            if backlog:
                emit(backlog)
            while True:
                emit(sub.next_events(timeout_s=5.0))
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # client went away
        finally:
            sub.unsubscribe()

    def _find_node(self, prefix: str):
        node = self.server.store.node_by_id(prefix)
        if node is not None:
            return node
        matches = self.server.store.node_by_prefix(prefix)
        if len(matches) > 1:
            raise ValueError(
                f"node prefix {prefix!r} matched {len(matches)} nodes")
        return matches[0] if matches else None

    @staticmethod
    def _unique_prefix(items, prefix: str, what: str):
        matches = [x for x in items if x.id.startswith(prefix)]
        if len(matches) > 1:
            raise ValueError(
                f"{what} prefix {prefix!r} matched {len(matches)} {what}s")
        return matches[0] if matches else None

    @staticmethod
    def _job_stub(job) -> dict:
        return {
            "ID": job.id, "Name": job.name, "Type": job.type,
            "Priority": job.priority, "Status": job.status,
            "Stop": job.stop,
            "JobModifyIndex": job.job_modify_index,
        }
