"""The command line interface.

Reference semantics: command/ (~170 commands via mitchellh/cli; the core
operator surface is implemented here: agent, job run/status/stop/init,
node status/eligibility/drain, alloc status, eval status, server info).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time
from typing import List, Optional

from ..api.client import ApiClient, ApiError
from ..utils.ids import short_id


def _client(args) -> ApiClient:
    return ApiClient(args.address, token=getattr(args, "token", ""),
                     region=getattr(args, "region", "") or "")


def _print_rows(rows: List[List[str]], header: List[str]) -> None:
    table = [header] + rows
    widths = [max(len(str(r[i])) for r in table) for i in range(len(header))]
    for r in table:
        print("  ".join(str(c).ljust(w) for c, w in zip(r, widths)).rstrip())


# -- agent -------------------------------------------------------------
def parse_region_peers(specs) -> dict:
    """-region-peer west=10.0.0.5:4646 (repeatable) -> {name: addr}."""
    peers = {}
    for spec in specs:
        name, _, addr = spec.partition("=")
        if not name or not addr:
            raise ValueError(
                f"bad -region-peer {spec!r} (want name=host:port)")
        peers[name] = addr
    return peers


class Agent:
    """A started agent: its Server, RpcServer and HTTPApiServer (None on
    a client-only agent) and its local Clients."""

    def __init__(self, server, rpc, api):
        self.server = server
        self.rpc = rpc
        self.api = api
        self.clients = []

    def shutdown(self) -> None:
        if self.api is not None:
            self.api.shutdown()
        for c in self.clients:
            c.shutdown()
        if self.rpc is not None:
            self.rpc.shutdown()
        if self.server is not None:
            self.server.shutdown()


def _device_line(device) -> str:
    if device.type == "cuda":
        import torch
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return f"{device} (the kernels' plain versions)"


def _start_server(args, region_peers, alloc_dir_bases):
    """The server half: the Server on `-device`, its RpcServer (and raft
    with -server-peers) and the HTTP API, which reads the alloc dirs
    under `alloc_dir_bases` itself, each started; on a failure what did
    start is stopped and the error raised."""
    from ..api import HTTPApiServer
    from ..rpc import RpcServer
    from ..server import Server, ServerConfig
    server = Server(ServerConfig(num_schedulers=args.num_schedulers,
                                 acl_enabled=args.acl_enabled,
                                 gc_safepoints=True,
                                 heartbeat_ttl_s=args.heartbeat_ttl,
                                 region=getattr(args, "region", "")
                                 or "global",
                                 region_peers=region_peers,
                                 authoritative_region=getattr(
                                     args, "authoritative_region",
                                     "") or "",
                                 replication_token=getattr(
                                     args, "replication_token",
                                     "") or "",
                                 data_dir=getattr(args, "data_dir", "")),
                    device=args.device or None)
    # a listener's shutdown waits for its serving loop, so only a
    # started one is shut down
    started = []
    try:
        rpc = RpcServer(server, port=args.rpc_port)
        server.rpc_server = rpc
        if args.server_peers:
            peers = [p.strip() for p in args.server_peers.split(",")
                     if p.strip()]
            server.attach_raft(rpc, peers)
        server.start()
        rpc.start()
        started.append(rpc)
        # region_peers defaults from server.config inside HTTPApiServer
        api = HTTPApiServer(server, port=args.http_port,
                            alloc_dir_bases=alloc_dir_bases)
        api.start()
    except BaseException:
        for part in reversed(started):
            part.shutdown()
        server.shutdown()
        raise
    return server, rpc, api


def start_agent(args) -> Agent:
    """Build and start an agent from parsed `agent` arguments. Its
    server half (-dev, -server): the Server on `-device` (the CUDA card
    unless `-device cpu`; without a card this raises), its RpcServer
    (and raft with -server-peers) and the HTTP API. Its client half
    (-dev, -client): `-clients N` local Clients, joined in-process to
    this agent's server, or with -client alone over RemoteTransport to
    `-servers`. A bad configuration raises ValueError."""
    if args.config:
        from .agent_config import apply_to_args, load_agent_config
        try:
            apply_to_args(load_agent_config(args.config), args)
        except (OSError, ValueError) as e:
            raise ValueError(f"loading config {args.config}: {e}")
    is_server = args.dev or args.server
    is_client = args.dev or args.client
    if not is_server and not is_client:
        raise ValueError("specify -dev, -server and/or -client")
    if is_client and not is_server and not args.servers:
        raise ValueError("-client requires -servers host:port")
    region_peers = parse_region_peers(
        getattr(args, "region_peers", None) or [])

    server = rpc = api = None
    if is_server:
        # the fs and logs routes read the alloc dirs of this agent's own
        # clients (AllocDir's default base unless -alloc-dir) and
        # forward every other alloc's request to its client
        local = is_client and args.clients > 0
        bases = [args.alloc_dir_base or os.path.join(
            tempfile.gettempdir(), "nomad-tpu-allocs")] if local else []
        server, rpc, api = _start_server(args, region_peers, bases)
    agent = Agent(server, rpc, api)
    try:
        from ..client import Client, ClientConfig
        client_kw = dict(
            alloc_dir=args.alloc_dir_base,
            state_dir=getattr(args, "state_dir", None) or None,
            datacenter=getattr(args, "datacenter", "") or "dc1",
            meta=getattr(args, "client_meta", None) or {},
            cloud_fingerprint=getattr(args, "cloud_fingerprint", False))
        for i in range(args.clients if is_client else 0):
            if server is not None:
                c = Client(server, ClientConfig(
                    node_name=args.node_name or f"dev-client-{i}",
                    **client_kw))
            else:
                from ..rpc import RemoteTransport
                c = Client(RemoteTransport(args.servers),
                           ClientConfig(node_name=args.node_name or
                                        f"client-{i}", **client_kw))
            agent.clients.append(c)
            c.start()
    except BaseException:
        agent.shutdown()
        raise
    return agent


def cmd_agent(args) -> int:
    try:
        agent = start_agent(args)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    mode = "dev" if args.dev else \
        "+".join(m for m, on in (("server", args.server),
                                 ("client", args.client)) if on)
    print(f"==> nomad-tpu agent started ({mode} mode)")
    if agent.api is not None:
        print(f"    HTTP API: http://127.0.0.1:{agent.api.port}")
    if agent.rpc is not None:
        print(f"    RPC:      {agent.rpc.addr}")
    if agent.clients:
        print(f"    Nodes:    {len(agent.clients)}")
    if agent.server is not None:
        print(f"    Workers:  {args.num_schedulers}")
        print(f"    Device:   {_device_line(agent.server.device)}")
    sys.stdout.flush()

    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        print("==> shutting down")
        agent.shutdown()
    return 0


# -- job ---------------------------------------------------------------
def cmd_job_init(args) -> int:
    from .example_job import EXAMPLE_JOB
    path = args.filename
    try:
        with open(path, "x") as f:
            f.write(EXAMPLE_JOB)
    except FileExistsError:
        print(f"Job file {path} already exists", file=sys.stderr)
        return 1
    print(f"Example job file written to {path}")
    return 0


def _collect_vars(args) -> dict:
    """-var k=v flags + NOMAD_VAR_* env (jobspec2 variable inputs)."""
    out = {}
    for k, v in os.environ.items():
        if k.startswith("NOMAD_VAR_"):
            out[k[len("NOMAD_VAR_"):]] = v
    for kv in getattr(args, "var", None) or []:
        if "=" not in kv:
            raise ValueError(f"-var expects key=value, got {kv!r}")
        k, v = kv.split("=", 1)
        out[k] = v
    return out


def cmd_job_run(args) -> int:
    from ..jobspec import parse_job, job_to_spec
    try:
        with open(args.jobfile) as f:
            job = parse_job(f.read(), variables=_collect_vars(args))
    except OSError as e:
        print(f"Error reading job file: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"Error parsing job file {args.jobfile}: {e}", file=sys.stderr)
        return 1
    c = _client(args)
    try:
        resp = c.register_job(job_to_spec(job),
                              check_index=getattr(args, "check_index",
                                                  None))
    except ApiError as e:
        print(f"Error submitting job: {e}", file=sys.stderr)
        return 1
    if not resp.get("EvalID"):
        # periodic/parameterized jobs register without an eval
        print(f"Job registration successful (no evaluation: "
              f"\"{job.id}\" is periodic or parameterized)")
        return 0
    print(f"==> Evaluation {short_id(resp['EvalID'])} triggered by job "
          f"\"{job.id}\"")
    if args.detach:
        return 0
    return _monitor_eval(c, resp["EvalID"])


def _monitor_eval(c: ApiClient, eval_id: str, timeout: float = 30.0) -> int:
    deadline = time.time() + timeout
    last_status = ""
    while time.time() < deadline:
        try:
            ev = c.get_evaluation(eval_id)
        except ApiError:
            time.sleep(0.2)
            continue
        if ev["status"] != last_status:
            last_status = ev["status"]
            print(f"    Evaluation status: {last_status}")
        if last_status in ("complete", "failed", "canceled"):
            if ev.get("blocked_eval"):
                print(f"    Blocked eval {short_id(ev['blocked_eval'])} "
                      f"created (insufficient capacity)")
            if ev.get("failed_tg_allocs"):
                for tg, metric in ev["failed_tg_allocs"].items():
                    print(f"    Task group {tg!r} failed to place: "
                          f"{metric.get('constraint_filtered') or metric.get('dimension_exhausted')}")
            print(f"==> Evaluation \"{short_id(eval_id)}\" finished with "
                  f"status \"{last_status}\"")
            return 0 if last_status == "complete" else 1
        time.sleep(0.2)
    print("timed out waiting for evaluation", file=sys.stderr)
    return 1


def cmd_job_status(args) -> int:
    c = _client(args)
    if not args.job_id:
        jobs = c.list_jobs()
        if not jobs:
            print("No running jobs")
            return 0
        _print_rows([[j["ID"], j["Type"], str(j["Priority"]), j["Status"]]
                     for j in jobs], ["ID", "Type", "Priority", "Status"])
        return 0
    try:
        job = c.get_job(args.job_id)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"ID            = {job['id']}")
    print(f"Name          = {job['name']}")
    print(f"Type          = {job['type']}")
    print(f"Priority      = {job['priority']}")
    print(f"Datacenters   = {','.join(job['datacenters'])}")
    print(f"Status        = {job['status']}")
    summary = c.job_summary(args.job_id)
    if summary:
        print("\nSummary")
        rows = []
        for tg, counts in sorted(summary.get("summary", {}).items()):
            rows.append([tg] + [str(counts.get(k, 0)) for k in
                                ("starting", "running", "complete", "failed",
                                 "lost")])
        _print_rows(rows, ["Task Group", "Starting", "Running", "Complete",
                           "Failed", "Lost"])
    allocs = c.job_allocations(args.job_id)
    if allocs:
        print("\nAllocations")
        _print_rows(
            [[short_id(a["id"]), short_id(a["node_id"] or "--------"),
              a["task_group"], a["desired_status"], a["client_status"]]
             for a in allocs],
            ["ID", "Node ID", "Task Group", "Desired", "Status"])
    return 0


def cmd_job_stop(args) -> int:
    c = _client(args)
    try:
        resp = c.deregister_job(args.job_id, purge=args.purge)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"==> Evaluation {short_id(resp['EvalID'])} triggered by job "
          f"deregister")
    if args.detach:
        return 0
    return _monitor_eval(c, resp["EvalID"])


def cmd_job_plan(args) -> int:
    from ..jobspec import parse_job, job_to_spec
    try:
        with open(args.jobfile) as f:
            job = parse_job(f.read())
    except (OSError, ValueError) as e:
        print(f"Error reading job file: {e}", file=sys.stderr)
        return 1
    c = _client(args)
    try:
        result = c.plan_job(job.id, job_to_spec(job))
    except ApiError as e:
        print(f"Error during plan: {e}", file=sys.stderr)
        return 1
    _print_job_diff(result.get("diff") or {})
    print("\nScheduler dry-run:")
    failed = result.get("failed_tg_allocs") or {}
    if not failed:
        print("- All tasks successfully allocated.")
    else:
        for tg, metric in failed.items():
            print(f"- WARNING: Failed to place allocations for task group "
                  f"{tg!r}.")
            for k in ("constraint_filtered", "dimension_exhausted"):
                if metric.get(k):
                    print(f"    {k}: {metric[k]}")
    ann = result.get("annotations") or {}
    for tg, upd in (ann.get("desired_tg_updates") or {}).items():
        parts = [f"{k}: {v}" for k, v in sorted(upd.items()) if v]
        if parts:
            print(f"  Task group {tg!r}: " + ", ".join(parts))
    return 1 if failed else 0


_DIFF_MARK = {"Added": "+", "Deleted": "-", "Edited": "~", "None": " "}


def _print_job_diff(diff: dict, indent: str = "") -> None:
    if not diff:
        return
    mark = _DIFF_MARK.get(diff.get("Type", "None"), " ")
    print(f"{indent}{mark} Job: {diff.get('ID', '')!r}")
    for f in diff.get("Fields", []):
        print(f"{indent}  {_DIFF_MARK[f['Type']]} {f['Name']}: "
              f"{f['Old']!r} => {f['New']!r}")
    for tg in diff.get("TaskGroups", []):
        updates = tg.get("Updates") or {}
        counts = " (" + ", ".join(
            f"{v} {k}" for k, v in sorted(updates.items())) + ")" \
            if updates else ""
        print(f"{indent}{_DIFF_MARK[tg['Type']]} Task Group: "
              f"{tg.get('Name', '')!r}{counts}")
        _print_object_diff(tg, indent + "  ")
        for task in tg.get("Tasks", []):
            ann = task.get("Annotations") or []
            suffix = f" ({', '.join(ann)})" if ann else ""
            print(f"{indent}  {_DIFF_MARK[task['Type']]} Task: "
                  f"{task.get('Name', '')!r}{suffix}")
            _print_object_diff(task, indent + "    ")


def _print_object_diff(obj: dict, indent: str) -> None:
    for f in obj.get("Fields", []):
        ann = f.get("Annotations") or []
        suffix = f" ({', '.join(ann)})" if ann else ""
        print(f"{indent}{_DIFF_MARK[f['Type']]} {f['Name']}: "
              f"{f['Old']!r} => {f['New']!r}{suffix}")
    for o in obj.get("Objects", []):
        print(f"{indent}{_DIFF_MARK[o['Type']]} {o.get('Name', '')}")
        _print_object_diff(o, indent + "  ")


def cmd_job_scale(args) -> int:
    c = _client(args)
    try:
        resp = c.scale_job(args.job_id, args.group, args.count)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"==> Evaluation {short_id(resp['EvalID'])} triggered by job "
          f"scale")
    if args.detach:
        return 0
    return _monitor_eval(c, resp["EvalID"])


# -- deployment --------------------------------------------------------
def cmd_deployment_list(args) -> int:
    c = _client(args)
    deployments = c.list_deployments()
    if not deployments:
        print("No deployments")
        return 0
    _print_rows(
        [[short_id(d["id"]), d["job_id"], str(d["job_version"]), d["status"],
          d["status_description"]] for d in deployments],
        ["ID", "Job ID", "Job Version", "Status", "Description"])
    return 0


def cmd_deployment_status(args) -> int:
    c = _client(args)
    try:
        d = c.get_deployment(args.deployment_id)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"ID          = {short_id(d['id'])}")
    print(f"Job ID      = {d['job_id']}")
    print(f"Job Version = {d['job_version']}")
    print(f"Status      = {d['status']}")
    print(f"Description = {d['status_description']}")
    if d.get("task_groups"):
        print("\nDeployed")
        rows = []
        for tg, s in sorted(d["task_groups"].items()):
            rows.append([tg, str(s["auto_revert"]), str(s["promoted"])
                         if s["desired_canaries"] else "N/A",
                         str(s["desired_total"]), str(s["placed_allocs"]),
                         str(s["healthy_allocs"]), str(s["unhealthy_allocs"])])
        _print_rows(rows, ["Task Group", "Auto Revert", "Promoted", "Desired",
                           "Placed", "Healthy", "Unhealthy"])
    return 0


def cmd_deployment_promote(args) -> int:
    c = _client(args)
    try:
        resp = c.promote_deployment(args.deployment_id,
                                    args.group or None)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"==> Evaluation {short_id(resp['EvalID'])} triggered by "
          f"deployment promotion")
    if args.detach:
        return 0
    return _monitor_eval(c, resp["EvalID"])


def cmd_deployment_fail(args) -> int:
    c = _client(args)
    try:
        resp = c.fail_deployment(args.deployment_id)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Deployment {short_id(args.deployment_id)} marked as failed")
    if resp.get("EvalID") and not args.detach:
        return _monitor_eval(c, resp["EvalID"])
    return 0


def cmd_deployment_pause(args) -> int:
    c = _client(args)
    try:
        c.pause_deployment(args.deployment_id, pause=not args.resume)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Deployment {short_id(args.deployment_id)} "
          f"{'resumed' if args.resume else 'paused'}")
    return 0


def cmd_job_revert(args) -> int:
    c = _client(args)
    try:
        resp = c.revert_job(args.job_id, args.version)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"==> Evaluation {short_id(resp['EvalID'])} triggered by job "
          f"revert")
    if args.detach:
        return 0
    return _monitor_eval(c, resp["EvalID"])


def cmd_job_history(args) -> int:
    c = _client(args)
    try:
        versions = c.job_versions(args.job_id)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    for v in sorted(versions, key=lambda j: -j["version"]):
        print(f"Version     = {v['version']}")
        print(f"Stable      = {v['stable']}")
        print(f"Submit Date = {v.get('submit_time', '')}")
        print("")
    return 0


# -- node --------------------------------------------------------------
def cmd_node_status(args) -> int:
    c = _client(args)
    if not args.node_id:
        nodes = c.list_nodes()
        if not nodes:
            print("No nodes registered")
            return 0
        _print_rows(
            [[short_id(n["id"]), n["name"], n["datacenter"],
              n["scheduling_eligibility"], n["status"]] for n in nodes],
            ["ID", "Name", "DC", "Eligibility", "Status"])
        return 0
    try:
        node = c.get_node(args.node_id)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"ID          = {short_id(node['id'])}")
    print(f"Name        = {node['name']}")
    print(f"Class       = {node['node_class'] or '<none>'}")
    print(f"DC          = {node['datacenter']}")
    print(f"Drain       = {node['drain']}")
    print(f"Eligibility = {node['scheduling_eligibility']}")
    print(f"Status      = {node['status']}")
    res = node["node_resources"]
    print(f"Resources   = cpu: {res['cpu']['cpu_shares']} MHz, "
          f"memory: {res['memory']['memory_mb']} MiB, "
          f"disk: {res['disk']['disk_mb']} MiB")
    if getattr(args, "stats", False):
        _render_host_stats(c, node["id"])
    allocs = c.node_allocations(node["id"])
    if allocs:
        print("\nAllocations")
        _print_rows(
            [[short_id(a["id"]), a["task_group"], a["desired_status"],
              a["client_status"]] for a in allocs],
            ["ID", "Task Group", "Desired", "Status"])
    return 0


def _render_host_stats(c: ApiClient, node_id: str) -> None:
    """`node status -stats`: the node's live HostStats, proxied by the
    server to the owning client."""
    try:
        hs = c.client_host_stats(node_id)
    except ApiError as e:
        print(f"\nHost Resource Utilization\n  unavailable: {e}")
        return
    if not hs.get("enabled", True):
        print("\nHost Resource Utilization\n  stats sampler disabled "
              "on this node (stats_sample_interval_s=0)")
        return
    mem = hs.get("Memory") or {}
    disk = (hs.get("DiskStats") or [{}])[0]
    cpu = (hs.get("CPU") or [{}])[0]
    mib = 1024.0 * 1024.0
    print("\nHost Resource Utilization")
    print(f"  CPU     = {cpu.get('TotalPercent', 0.0):.1f}%")
    print(f"  Memory  = {mem.get('Used', 0) / mib:.0f} MiB / "
          f"{mem.get('Total', 0) / mib:.0f} MiB")
    print(f"  Disk    = {disk.get('Used', 0) / mib:.0f} MiB / "
          f"{disk.get('Size', 0) / mib:.0f} MiB "
          f"({disk.get('UsedPercent', 0.0):.1f}%)")
    print(f"  Uptime  = {hs.get('Uptime', 0.0):.0f} s; allocs "
          f"running = {hs.get('AllocsRunning', 0)} "
          f"(reporting usage = {hs.get('AllocsReporting', 0)})")


def cmd_node_eligibility(args) -> int:
    if args.enable == args.disable:
        print("Exactly one of -enable or -disable is required",
              file=sys.stderr)
        return 1
    c = _client(args)
    try:
        c.set_node_eligibility(args.node_id, args.enable)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Node {short_id(args.node_id)} scheduling eligibility: "
          f"{'eligible' if args.enable else 'ineligible'}")
    return 0


def cmd_node_drain(args) -> int:
    if args.enable == args.disable:
        print("Exactly one of -enable or -disable is required",
              file=sys.stderr)
        return 1
    c = _client(args)
    try:
        if args.enable:
            c.drain_node(args.node_id, deadline_s=args.deadline)
            print(f"Node {short_id(args.node_id)} drain strategy set")
        else:
            c.drain_node(args.node_id, enable=False, mark_eligible=True)
            print(f"Node {short_id(args.node_id)} drain disabled")
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if args.enable and getattr(args, "monitor", False):
        return _monitor_drain(c, args.node_id)
    return 0


def _monitor_drain(c: ApiClient, node_id: str,
                   timeout: float = 600.0) -> int:
    """Block until the node finishes draining, reporting alloc
    migrations as they happen (command/node_drain.go -monitor +
    api/nodes.go MonitorDrain)."""
    seen: dict = {}
    deadline = time.time() + timeout
    print(f"{time.strftime('%H:%M:%S')}: Monitoring node "
          f"{short_id(node_id)}: Ctrl-C to detach monitoring")
    while time.time() < deadline:
        try:
            node = c.get_node(node_id)
            allocs = c.node_allocations(node_id)
        except ApiError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        remaining = 0
        for a in allocs:
            status = (a.get("desired_status", ""),
                      a.get("client_status", ""))
            if seen.get(a["id"]) != status:
                seen[a["id"]] = status
                print(f"{time.strftime('%H:%M:%S')}: Alloc "
                      f"{short_id(a['id'])} status {status[1]} "
                      f"(desired {status[0]})")
            if a.get("desired_status") == "run" and \
                    a.get("client_status") in ("running", "pending"):
                remaining += 1
        draining = bool(node.get("drain"))
        if not draining and remaining == 0:
            print(f"{time.strftime('%H:%M:%S')}: Drain complete for "
                  f"node {short_id(node_id)}")
            return 0
        if not draining:
            # drain strategy cleared (deadline hit / canceled) but
            # allocs still present — report and finish
            print(f"{time.strftime('%H:%M:%S')}: Node drain strategy "
                  f"cleared; {remaining} alloc(s) still on node")
            return 0
        time.sleep(1.0)
    print("Error: drain monitor timed out", file=sys.stderr)
    return 1


# -- alloc / eval ------------------------------------------------------
def cmd_alloc_status(args) -> int:
    c = _client(args)
    try:
        a = c.get_allocation(args.alloc_id)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"ID         = {short_id(a['id'])}")
    print(f"Name       = {a['name']}")
    print(f"Node ID    = {short_id(a['node_id'])}")
    print(f"Job ID     = {a['job_id']}")
    print(f"Desired    = {a['desired_status']}")
    print(f"Status     = {a['client_status']}")
    for task, state in (a.get("task_states") or {}).items():
        print(f"\nTask \"{task}\" is \"{state['state']}\"" +
              (" (failed)" if state.get("failed") else ""))
    if getattr(args, "stats", False):
        # live task-level ResourceUsage from the owning client's
        # sampler
        try:
            st = c.alloc_stats(a["id"])
        except ApiError as e:
            print(f"\nResource Utilization\n  unavailable: {e}")
            st = None
        if st is not None and st.get("stats"):
            usage = st["stats"]
            mib = 1024.0 * 1024.0
            rows = []
            for task, tu in sorted((usage.get("Tasks") or {}).items()):
                ru = tu.get("ResourceUsage") or {}
                cpu = (ru.get("CpuStats") or {})
                memst = (ru.get("MemoryStats") or {})
                rows.append([task,
                             f"{cpu.get('Percent', 0.0):.1f}%",
                             f"{memst.get('RSS', 0) / mib:.1f} MiB"])
            print("\nResource Utilization")
            _print_rows(rows, ["Task", "CPU", "Memory (RSS)"])
        elif st is not None:
            print("\nResource Utilization\n  no live usage reported "
                  "(sampler disabled or alloc not running)")
    metrics = a.get("metrics")
    if metrics and metrics.get("score_meta_data"):
        print("\nPlacement Metrics")
        print(f"  Nodes evaluated: {metrics['nodes_evaluated']}; "
              f"filtered: {metrics['nodes_filtered']}; "
              f"exhausted: {metrics['nodes_exhausted']}")
        for sm in metrics["score_meta_data"][:3]:
            print(f"  {short_id(sm['node_id'])}: {sm['norm_score']:.4f}")
    return 0


def cmd_eval_status(args) -> int:
    c = _client(args)
    try:
        ev = c.get_evaluation(args.eval_id)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    for k in ("id", "type", "triggered_by", "job_id", "status",
              "status_description"):
        print(f"{k:<20}= {ev.get(k)}")
    if ev.get("queued_allocations"):
        print(f"{'queued':<20}= {ev['queued_allocations']}")
    return 0


def cmd_server_info(args) -> int:
    c = _client(args)
    info = c.agent_self()
    print(json.dumps(info, indent=2))
    return 0


def cmd_alloc_logs(args) -> int:
    c = _client(args)
    try:
        out = c._request(
            "GET", f"/v1/client/fs/logs/{args.alloc_id}",
            params={"task": args.task,
                    "type": "stderr" if args.stderr else "stdout"})
    except ApiError as e:
        print(f"Error reading logs: {e}", file=sys.stderr)
        return 1
    sys.stdout.write(out.get("Data", ""))
    return 0


def cmd_alloc_fs(args) -> int:
    c = _client(args)
    try:
        out = c._request("GET", f"/v1/client/fs/ls/{args.alloc_id}",
                         params={"path": args.path})
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    rows = [["d" if e["IsDir"] else "-", str(e["Size"]), e["Name"]]
            for e in out]
    _print_rows(rows, ["Mode", "Size", "Name"])
    return 0


def cmd_alloc_exec(args) -> int:
    """`nomad alloc exec` (command/alloc_exec.go): run a command inside
    the task environment, stdin piped through, stdout/stderr relayed
    until exit."""
    c = _client(args)
    cmd = [a for a in args.cmd if a != "--"]
    if not cmd:
        print("Error: a command is required", file=sys.stderr)
        return 1
    try:
        sid = c.alloc_exec_start(args.alloc_id, cmd, task=args.task)
    except ApiError as e:
        print(f"Error starting exec: {e}", file=sys.stderr)
        return 1
    stdin = b""
    if not sys.stdin.isatty():
        stdin = sys.stdin.buffer.read()
    sent = False
    code = 1
    try:
        while True:
            out = c.alloc_exec_io(args.alloc_id, sid,
                                  stdin=stdin if not sent else b"",
                                  close_stdin=not sent, wait_s=1.0)
            sent = True
            if out["stdout"]:
                sys.stdout.buffer.write(out["stdout"])
                sys.stdout.buffer.flush()
            if out["stderr"]:
                sys.stderr.buffer.write(out["stderr"])
                sys.stderr.buffer.flush()
            if out["exited"]:
                code = out["exit_code"]
                break
    except KeyboardInterrupt:
        c.alloc_exec_stop(args.alloc_id, sid)
        return 130
    return code


def cmd_job_dispatch(args) -> int:
    """`nomad job dispatch` (command/job_dispatch.go)."""
    import base64
    c = _client(args)
    meta = {}
    for kv in (args.meta or []):
        if "=" not in kv:
            print(f"Error: -meta expects key=value, got {kv!r}",
                  file=sys.stderr)
            return 1
        k, v = kv.split("=", 1)
        meta[k] = v
    body = {"Meta": meta}
    if args.payload:
        with open(args.payload, "rb") as f:
            body["Payload"] = base64.b64encode(f.read()).decode()
    try:
        out = c._request("POST", f"/v1/job/{args.job_id}/dispatch", body)
    except ApiError as e:
        print(f"Error dispatching: {e}", file=sys.stderr)
        return 1
    print(f"Dispatched Job ID = {out['DispatchedJobID']}")
    print(f"Evaluation ID     = {short_id(out['EvalID'])}")
    return 0


def cmd_job_inspect(args) -> int:
    """`nomad job inspect` — the stored job as JSON."""
    c = _client(args)
    try:
        job = c.get_job(args.job_id)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(job, indent=2, sort_keys=True, default=str))
    return 0


def cmd_job_validate(args) -> int:
    """`nomad job validate` — parse + server-side validation via the
    plan endpoint (command/job_validate.go)."""
    c = _client(args)
    try:
        with open(args.path) as f:
            spec = f.read()
        out = c._request("POST", "/v1/jobs/parse", {"JobHCL": spec})
    except (OSError, ApiError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Job \"{out.get('id', '?')}\" is valid")
    return 0


def cmd_job_eval(args) -> int:
    """`nomad job eval` — force a new evaluation."""
    c = _client(args)
    try:
        out = c._request("POST", f"/v1/job/{args.job_id}/evaluate", {})
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Created eval {short_id(out['EvalID'])}")
    return 0


def cmd_job_periodic_force(args) -> int:
    """`nomad job periodic force`."""
    c = _client(args)
    try:
        out = c._request("POST",
                         f"/v1/job/{args.job_id}/periodic/force", {})
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if out.get("Skipped"):
        print("Launch skipped (overlap prohibited or already launched)")
        return 0
    print(f"Dispatched {out.get('DispatchedJobID', '')} "
          f"(eval {short_id(out.get('EvalID', ''))})")
    return 0


def cmd_job_scaling_events(args) -> int:
    c = _client(args)
    out = c._request("GET", f"/v1/job/{args.job_id}/scaling-events")
    rows = [[str(ev.get("time", ""))[:19], str(ev.get("count", "")),
             ev.get("message", "")]
            for ev in out.get("ScalingEvents", [])]
    _print_rows(rows, ["Time", "Count", "Message"])
    return 0


def cmd_alloc_stop(args) -> int:
    """`nomad alloc stop` — stop and reschedule one allocation."""
    c = _client(args)
    try:
        out = c._request("POST", f"/v1/allocation/{args.alloc_id}/stop",
                         {})
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Created eval {short_id(out['EvalID'])}")
    return 0


def cmd_alloc_restart(args) -> int:
    # reference surface: `alloc restart [-task <name>] <alloc> [<task>]`
    # — the flag and the positional are alternatives (alloc_restart.go);
    # naming the task both ways must agree
    task = args.task_opt or args.task
    if args.task_opt and args.task and args.task_opt != args.task:
        print("Error: task name given both as -task flag and "
              "positional argument", file=sys.stderr)
        return 1
    c = _client(args)
    try:
        out = c._request(
            "POST", f"/v1/client/allocation/{args.alloc_id}/restart",
            {"Task": task})
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Restarted {out.get('restarted', 0)} task(s)")
    return 0


def cmd_alloc_signal(args) -> int:
    # reference surface: `alloc signal [-s <sig>] [-task <name>]
    # <alloc> [<task>]` (alloc_signal.go)
    task = args.task_opt or args.task
    if args.task_opt and args.task and args.task_opt != args.task:
        print("Error: task name given both as -task flag and "
              "positional argument", file=sys.stderr)
        return 1
    c = _client(args)
    try:
        out = c._request(
            "POST", f"/v1/client/allocation/{args.alloc_id}/signal",
            {"Task": task, "Signal": args.signal})
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Signalled {out.get('delivered', 0)} task(s)")
    return 0


def cmd_eval_list(args) -> int:
    c = _client(args)
    evals = c._request("GET", "/v1/evaluations")
    rows = [[short_id(e["id"]), e.get("type", ""),
             e.get("triggered_by", ""), e.get("job_id", "")[:24],
             e.get("status", "")] for e in evals]
    _print_rows(rows, ["ID", "Type", "Triggered By", "Job", "Status"])
    return 0


def cmd_scaling_policy_list(args) -> int:
    c = _client(args)
    pols = c.list_scaling_policies()
    rows = [[short_id(p["ID"]), p["Target"].get("Job", ""),
             p["Target"].get("Group", ""),
             "yes" if p["Enabled"] else "no", p["Type"]]
            for p in pols]
    _print_rows(rows, ["ID", "Job", "Group", "Enabled", "Type"])
    return 0


def cmd_scaling_policy_info(args) -> int:
    c = _client(args)
    try:
        p = c.get_scaling_policy(args.policy_id)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(p, indent=2, sort_keys=True, default=str))
    return 0


def cmd_version(args) -> int:
    from .. import __version__
    print(f"nomad-tpu v{__version__}")
    return 0


def cmd_ui(args) -> int:
    print(f"Web UI: {args.address}/ui")
    return 0


def cmd_status(args) -> int:
    """`nomad status [prefix]` — no-prefix lists jobs; a prefix
    searches every context (command/status.go)."""
    c = _client(args)
    if not args.prefix:
        args.job_id = ""
        return cmd_job_status(args)
    res = c.search(args.prefix)
    hits = [(ctx, m) for ctx, matches in
            (res.get("Matches") or {}).items() for m in matches]
    if not hits:
        print(f"No matches found for {args.prefix!r}")
        return 1
    rows = [[ctx, short_id(m) if len(m) > 30 else m]
            for ctx, m in hits]
    _print_rows(rows, ["Context", "ID"])
    return 0


def cmd_monitor(args) -> int:
    """Stream agent logs (command/agent_monitor.go)."""
    import urllib.request
    url = f"{args.address}/v1/agent/monitor?log_level={args.log_level}"
    req = urllib.request.Request(url)
    if getattr(args, "token", ""):
        req.add_header("X-Nomad-Token", args.token)
    import urllib.error
    try:
        with urllib.request.urlopen(req, timeout=3600) as resp:
            for line in resp:
                line = line.strip()
                if not line or line == b"{}":
                    continue
                print(json.loads(line).get("Data", ""))
    except KeyboardInterrupt:
        pass
    except urllib.error.HTTPError as e:
        try:
            msg = json.loads(e.read()).get("error", str(e))
        except Exception:
            msg = str(e)
        print(f"Error: {msg}", file=sys.stderr)
        return 1
    except urllib.error.URLError as e:
        print(f"Error: unable to reach agent: {e.reason}",
              file=sys.stderr)
        return 1
    return 0


def cmd_volume_status(args) -> int:
    c = _client(args)
    if args.volume_id:
        try:
            v = c.get_volume(args.volume_id, namespace=args.namespace)
        except ApiError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        print(json.dumps(v, indent=2, sort_keys=True, default=str))
        return 0
    rows = [[v.get("id", ""), v.get("plugin_id", ""),
             str(v.get("schedulable", "")),
             v.get("access_mode", "")]
            for v in c.list_volumes(namespace=args.namespace)]
    _print_rows(rows, ["ID", "Plugin", "Schedulable", "Access mode"])
    return 0


def cmd_volume_register(args) -> int:
    c = _client(args)
    from ..jobspec.hcl import parse_hcl
    try:
        with open(args.file) as f:
            raw = f.read()
        spec = json.loads(raw) if raw.strip().startswith("{") \
            else parse_hcl(raw)
        body = spec.get("volume", spec)
        if isinstance(body, dict) and len(body) == 1 and \
                isinstance(next(iter(body.values())), dict):
            vol_id, body = next(iter(body.items()))
            body.setdefault("id", vol_id)
        c.register_volume(body, namespace=args.namespace)
    except (OSError, ValueError, ApiError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Volume {body.get('id', '')} registered")
    return 0


def cmd_volume_deregister(args) -> int:
    c = _client(args)
    try:
        c.deregister_volume(args.volume_id, force=args.force,
                            namespace=args.namespace)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Volume {args.volume_id} deregistered")
    return 0


def cmd_operator_debug(args) -> int:
    """Capture a debug archive (command/operator_debug.go): cluster
    state, agent info, metrics sampled over -duration at -interval,
    pprof analogs, and the monitor log — bundled as a .tar.gz the
    operator attaches to a support ticket."""
    import io
    import tarfile
    c = _client(args)
    # a zero/negative interval would busy-loop metrics captures against
    # the very agent being debugged
    args.interval = max(args.interval, 0.2)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    out_path = args.output or f"nomad-debug-{stamp}.tar.gz"
    root = f"nomad-debug-{stamp}"
    captures = 0

    try:
        tar = tarfile.open(out_path, "w:gz")
    except OSError as e:
        print(f"Error opening {out_path}: {e}", file=sys.stderr)
        return 1

    def add(name: str, payload) -> None:
        nonlocal captures
        if not isinstance(payload, (bytes, bytearray)):
            payload = json.dumps(payload, indent=2,
                                 default=str).encode()
        info = tarfile.TarInfo(f"{root}/{name}")
        info.size = len(payload)
        info.mtime = int(time.time())
        tar.addfile(info, io.BytesIO(bytes(payload)))
        captures += 1

    def try_add(name: str, fn) -> None:
        try:
            add(name, fn())
        except Exception as e:
            add(name + ".error", {"error": str(e)})

    # one-shot cluster captures
    try_add("agent-self.json", c.agent_self)
    try_add("members.json",
            lambda: c._request("GET", "/v1/operator/members"))
    # scheduler-plane view: per-member role/applied/fence
    # lag + the leader's eval-lease counters ride in the bundle
    try_add("scheduler-plane.json",
            lambda: c._request("GET", "/v1/agent/members"))
    try_add("raft-status.json",
            lambda: c._request("GET", "/v1/operator/raft/configuration"))
    try_add("autopilot.json", c.autopilot_config)
    try_add("governor.json", c.governor)
    # flight recorder: exemplar span trees + stage percentiles ride in
    # the bundle, so a support ticket carries the anatomy of the worst
    # evals, not just gauge values
    try_add("trace.json", c.trace)
    try_add("trace-chrome.json",
            lambda: c.trace({"format": "chrome"}))
    # retained telemetry: the whole in-process history ring
    # + the live flatness verdict + a Prometheus-format snapshot ride
    # in the bundle ONE-SHOT — the interval poll below only adds
    # samples taken during the capture window, but the ring carries
    # the minutes BEFORE the operator ran this command, which is
    # where the incident usually lives
    try_add("telemetry.json", c.telemetry)
    try_add("flatness.json", c.flatness)
    try_add("metrics.prom",
            lambda: c.metrics(format="prometheus").encode())
    # latest chaos artifact: when an operator has run `nomad dev chaos`
    # on this machine, the newest CHAOS_rNN.json rides in the bundle as
    # chaos.json — a support ticket carries the invariant verdicts the
    # cluster last proved, not just its gauges
    from ..chaos.matrix import latest_artifact
    chaos_path = latest_artifact(".")
    if chaos_path is not None:
        def _read_chaos(p=chaos_path):
            with open(p, "rb") as f:
                return f.read()
        try_add("chaos.json", _read_chaos)
    try_add("scheduler-config.json", c.scheduler_config)
    try_add("nomad/jobs.json", c.list_jobs)
    # per-node live host stats: each reachable client's
    # HostStats + its retained client-side ring ride the bundle, so a
    # ticket carries the fleet's host truth, not just server state
    try:
        nodes = c.list_nodes()
        add("nomad/nodes.json", nodes)
        for n in nodes:
            try_add(f"nomad/client-stats/{n['id'][:8]}.json",
                    lambda nid=n["id"]: c.client_host_stats(
                        nid, history=True))
    except Exception as e:
        add("nomad/nodes.json.error", {"error": str(e)})
    try_add("nomad/allocations.json", c.list_allocations)
    try_add("nomad/deployments.json", c.list_deployments)
    try_add("nomad/volumes.json", c.list_volumes)
    try_add("pprof/threads.json", c.agent_threads)
    try_add("pprof/profile.json",
            lambda: c.agent_profile(seconds=min(args.duration, 2.0)))

    # interval captures over the window (metrics time series)
    end = time.time() + max(args.duration, 0.0)
    i = 0
    while True:
        try_add(f"metrics/metrics_{i:03d}.json", c.metrics)
        i += 1
        if time.time() >= end:
            break
        time.sleep(min(args.interval, max(end - time.time(), 0.0)))

    add("index.json", {
        "timestamp": stamp,
        "duration_s": args.duration,
        "interval_s": args.interval,
        "captures": captures,
        "cli": "nomad-tpu operator debug",
    })
    tar.close()
    print(f"Created debug archive: {out_path} ({captures} captures)")
    return 0


def cmd_operator_governor(args) -> int:
    """Steady-state governor status (governor/): every governed
    structure's gauge with watermark state, the backpressure signal,
    and recent structured events (watermark crossings, reclaims, drift
    findings)."""
    c = _client(args)
    try:
        out = c.governor()
    except ApiError as e:
        print(f"Error querying governor: {e}", file=sys.stderr)
        return 1
    if not out.get("enabled", False):
        print("Governor disabled on this agent")
        return 0
    print(f"Backpressure  = {'ENGAGED' if out.get('backpressure') else 'off'}")
    print(f"Service p99   = {out.get('service_p99_ms', 0.0)} ms "
          f"({out.get('latency_samples', 0)} samples)")
    print(f"Process RSS   = {out.get('process_rss_mb', 0.0)} MB")
    print(f"Samples       = {out.get('samples', 0)} "
          f"(every {out.get('interval_s', 0)}s)")
    print()
    rows = []
    for g in out.get("gauges", []):
        high = g.get("high")
        wm = (f"{g['value']:.0f}/{high:.0f}" if high is not None
              else f"{g['value']:.0f}")
        status = g.get("status", "ok") if high is not None else "-"
        if g.get("pressure"):
            status += " (pressure)"
        rows.append([g["name"], wm, g.get("unit", "count"), status,
                     g.get("reclaims", 0)])
    _print_rows(rows, ["Structure", "Value/High", "Unit", "Status",
                       "Reclaims"])
    events = out.get("events", [])[-10:]
    if events:
        print()
        print(f"Recent events ({len(events)}):")
        for e in events:
            ts = time.strftime("%H:%M:%S",
                               time.localtime(e.get("ts", 0)))
            kind = e.get("kind", "event")
            detail = {k: v for k, v in e.items()
                      if k not in ("ts", "kind")}
            print(f"  {ts}  {kind:12s} {json.dumps(detail, default=str)}")
    # runtime race sanitizer (analysis/race.py, NOMAD_TPU_RACE=1):
    # aggregate lock traffic + the worst-holder exemplars
    locks = out.get("locks") or {}
    if locks.get("enabled"):
        print()
        print(f"Lock traffic (NOMAD_TPU_RACE=1): "
              f"{locks.get('tracked', 0)} tracked, "
              f"{locks.get('order_edges', 0)} order edges, "
              f"{locks.get('findings_unsuppressed', 0)} finding(s)")
        rows = [[l["name"], l["instances"], l["acquires"],
                 l["contended"], f"{l['max_hold_ms']:.1f}",
                 l["hold_warns"]]
                for l in locks.get("locks", [])[:8]]
        if rows:
            _print_rows(rows, ["Lock", "Inst", "Acquires",
                               "Contended", "MaxHold(ms)", "Warns"])
        for e in locks.get("worst_holders", [])[:4]:
            print(f"  worst holder {e['lock']}: {e['hold_ms']:.1f} ms "
                  f"in {e['thread']}  {e.get('holder', '')}")
    return 0


def cmd_operator_trace(args) -> int:
    """Eval flight recorder (trace/): per-eval span trees,
    tail exemplars with governor-gauge snapshots, per-stage
    percentiles. `-o chrome` emits Chrome trace-event JSON — load it
    in Perfetto (ui.perfetto.dev) or chrome://tracing; one track per
    worker / gateway / applier so cross-thread overlap is visible."""
    c = _client(args)
    params = {"n": str(args.n)}
    if args.exemplars:
        params["exemplars"] = "true"
    if args.o == "chrome":
        params["format"] = "chrome"
    try:
        out = c.trace(params)
    except ApiError as e:
        print(f"Error querying trace: {e}", file=sys.stderr)
        return 1
    if args.o == "chrome":
        payload = json.dumps(out)
        if args.output:
            with open(args.output, "w") as f:
                f.write(payload)
            print(f"Wrote {len(out.get('traceEvents', []))} trace "
                  f"events to {args.output} (load in Perfetto / "
                  f"chrome://tracing)")
        else:
            print(payload)
        return 0
    if not out.get("enabled", False):
        print("Flight recorder disabled on this agent "
              "(trace_enabled=False)")
        return 0
    ring = out.get("ring", {})
    st = out.get("stats", {})
    print(f"Traces        = {ring.get('traces', 0)} in ring "
          f"({ring.get('bytes', 0)}/{ring.get('bytes_max', 0)} bytes); "
          f"{st.get('traces', 0)} recorded, {st.get('dropped', 0)} "
          f"aged out")
    print(f"Exemplars     = {len(out.get('exemplars', []))}"
          f"/{out.get('exemplar_slots', 0)} "
          f"(threshold {out.get('threshold_ms', 0.0)} ms, "
          f"{st.get('exemplar_pins', 0)} pinned)")
    print()
    rows = []
    for stage, p in out.get("stage_percentiles", {}).items():
        rows.append([stage, p["p50_ms"], p["p95_ms"], p["p99_ms"],
                     p["count"]])
    if rows:
        _print_rows(rows, ["Stage", "p50 ms", "p95 ms", "p99 ms",
                           "Samples"])
    exemplars = out.get("exemplars", [])
    if exemplars:
        print()
        print(f"Tail exemplars ({len(exemplars)}):")
        for t in exemplars:
            pin = " PINNED " + t.get("reason", "") \
                if t.get("pinned") else ""
            print(f"  {t['eval_id'][:8]}  {t['total_ms']:9.1f} ms  "
                  f"{t.get('type', ''):8s} {t.get('job_id', '')} "
                  f"({len(t.get('spans', []))} spans){pin}")
            for sp in t.get("spans", []):
                attrs = sp.get("attrs")
                extra = f"  {json.dumps(attrs)}" if attrs else ""
                print(f"      {sp['t0_ms']:9.1f} +{sp['dur_ms']:8.2f}"
                      f"  {sp['name']:13s} [{sp.get('track', '')}]"
                      f"{extra}")
    return 0


def cmd_operator_top(args) -> int:
    """Live rates and trends from the retained telemetry ring:
    evals/s and placements/s from counter deltas, the p99 trend
    over history, recent per-stage latency shares, the device
    economics the TPU validation campaign reads (pad waste, per-arm
    dispatch seconds + compiles, kernel cache, mirror/HBM bytes, lane
    occupancy), the live flatness verdict, and drift annotations from
    the governor's event log — `/v1/metrics` shows a point in time,
    this shows where the numbers are GOING."""
    from statistics import median
    c = _client(args)
    try:
        tel = c.telemetry(last=args.n)
    except ApiError as e:
        print(f"Error querying telemetry: {e}", file=sys.stderr)
        return 1
    if not tel.get("enabled", True) or "series" not in tel:
        print("Telemetry collector disabled on this agent "
              "(telemetry_sample_interval_s=0)")
        return 0
    series = tel.get("series", {})
    rates = tel.get("rates", {})

    def tail_vals(d, name):
        return [v for v in d.get(name, []) if v is not None]

    def rate_now(name, k=5):
        vals = tail_vals(rates, name)
        return (sum(vals[-k:]) / len(vals[-k:])) if vals else 0.0

    def rate_peak(name):
        vals = tail_vals(rates, name)
        return max(vals) if vals else 0.0

    ring_kib = tel.get("ring_bytes", 0) / 1024.0
    print(f"Telemetry     = {tel.get('samples', 0)} samples @ "
          f"{tel.get('interval_s', 0)}s "
          f"({tel.get('series_count', 0)} series, ring "
          f"{ring_kib:.0f} KiB)")
    print(f"Evals/s       = "
          f"{rate_now('counter.nomad.worker.eval_processed'):.1f} now, "
          f"{rate_peak('counter.nomad.worker.eval_processed'):.1f} peak")
    print(f"Placements/s  = "
          f"{rate_now('counter.nomad.plan.placements'):.1f} now, "
          f"{rate_peak('counter.nomad.plan.placements'):.1f} peak")
    p99s = tail_vals(series, "latency.p99_ms")
    if p99s:
        half = max(1, len(p99s) // 2)
        first = median(p99s[:half]) or 0.0
        last = median(p99s[len(p99s) - half:])
        trend = (last / first) if first > 0 else 1.0
        p50s = tail_vals(series, "latency.p50_ms")
        print(f"Latency       = p50 {p50s[-1] if p50s else 0.0:.1f} ms, "
              f"p99 {p99s[-1]:.1f} ms "
              f"(trend {trend:.2f}x first->last half)")
    rss = tail_vals(series, "process.rss_mb")
    if rss:
        print(f"RSS           = {rss[-1]:.1f} MB "
              f"(start of window {rss[0]:.1f} MB)")
    try:
        flat = c.flatness()
        if flat.get("enabled", flat.get("pass") is not None):
            if flat.get("pass") is None:
                verdict = f"n/a ({flat.get('reason', 'no verdict')})"
            elif flat["pass"]:
                verdict = "PASS"
            else:
                verdict = f"FAIL ({flat.get('reason', '?')})"
            print(f"Flatness      = {verdict} "
                  f"(p99 drift {flat.get('p99_drift_ratio', '?')}x, "
                  f"rss {flat.get('rss_slope_mb_per_hour', '?')} MB/h "
                  f"over {flat.get('windows_measured', 0)} windows)")
    except ApiError:
        pass

    # cluster rollup: fleet economics folded from the
    # clients' heartbeat host-stats payloads — allocated is what the
    # scheduler bin-packed, used is what the hosts actually burned
    nt = tail_vals(series, "cluster.nodes_total")
    if nt:
        def clast(name):
            vals = tail_vals(series, f"cluster.{name}")
            return vals[-1] if vals else 0.0
        print()
        print("Cluster:")
        print(f"  nodes              = {clast('nodes_total'):.0f} total, "
              f"{clast('nodes_ready'):.0f} ready, "
              f"{clast('nodes_down'):.0f} down "
              f"({clast('nodes_reporting'):.0f} reporting stats, "
              f"{clast('stale_heartbeats'):.0f} stale)")
        print(f"  fleet cpu          = "
              f"{clast('fleet_cpu_allocated_ratio'):.1%} allocated, "
              f"{clast('fleet_cpu_used_ratio'):.1%} used of "
              f"{clast('fleet_cpu_capacity_mhz'):.0f} MHz")
        print(f"  fleet memory       = "
              f"{clast('fleet_mem_allocated_ratio'):.1%} allocated, "
              f"{clast('fleet_mem_used_ratio'):.1%} used of "
              f"{clast('fleet_mem_capacity_mb'):.0f} MiB")
        if tail_vals(series, "cluster.node_cpu_pct_p50"):
            print(f"  node utilization   = cpu p50 "
                  f"{clast('node_cpu_pct_p50'):.1f}% / p99 "
                  f"{clast('node_cpu_pct_p99'):.1f}%, mem p50 "
                  f"{clast('node_mem_ratio_p50'):.1%} / p99 "
                  f"{clast('node_mem_ratio_p99'):.1%}")

    # write ingest block: the admission path's economics —
    # coalescing, shed, and the full write latency each submitter saw
    # (gauges land in the ring via the governor snapshot; the rates
    # come from the nomad.ingest.* counter deltas)
    if tail_vals(series, "ingest.batch_size"):
        def ilast(name):
            vals = tail_vals(series, f"ingest.{name}")
            return vals[-1] if vals else 0.0
        print()
        print("Write ingest:")
        print(f"  writes/s           = "
              f"{rate_now('counter.nomad.ingest.writes'):.1f} now, "
              f"{rate_peak('counter.nomad.ingest.writes'):.1f} peak "
              f"({rate_now('counter.nomad.ingest.batches'):.1f} "
              f"batches/s)")
        print(f"  write p99          = {ilast('write_p99_ms'):.2f} ms "
              f"(mean batch {ilast('batch_size'):.2f})")
        print(f"  coalesced          = {ilast('coalesced_writes'):.0f} "
              f"writes shared a raft entry, {ilast('shed'):.0f} shed")
        print(f"  queue              = {ilast('queue_depth'):.0f} deep, "
              f"window {ilast('window_us'):.0f} us")

    # recent per-stage share: p50 x reservoir occupancy approximates
    # each stage's recent seconds (reservoirs hold the last 2048
    # reports); superset/idle stages stay out of the denominator like
    # stages.snapshot()
    excluded = {"sched_host", "queue_wait"}
    stage_rows = []
    weights = {}
    for name in series:
        if name.startswith("stage.") and name.endswith(".p50_ms"):
            stage = name[len("stage."):-len(".p50_ms")]
            p50 = (tail_vals(series, name) or [0.0])[-1]
            p99 = (tail_vals(series, f"stage.{stage}.p99_ms")
                   or [0.0])[-1]
            cnt = (tail_vals(series, f"stage_count.{stage}")
                   or [0.0])[-1]
            weights[stage] = (p50 * cnt, p50, p99, cnt)
    denom = sum(w for s, (w, _p, _q, _c) in weights.items()
                if s not in excluded) or 1.0
    for stage in sorted(weights):
        w, p50, p99, cnt = weights[stage]
        share = 0.0 if stage in excluded else w / denom
        stage_rows.append([stage, f"{p50:.2f}", f"{p99:.2f}",
                           int(cnt), f"{share:.1%}"])
    if stage_rows:
        print()
        _print_rows(stage_rows, ["Stage", "p50 ms", "p99 ms",
                                 "Samples", "Recent share"])

    # device economics (the validation campaign's instruments)
    print()
    print("Device economics:")
    pw = tail_vals(series, "device.pad_waste_ratio")
    if pw:
        shipped = tail_vals(series, "device.pad_rows_shipped")
        print(f"  pad waste ratio    = {pw[-1]:.4f} "
              f"(rows shipped {shipped[-1] if shipped else 0:.0f})")
    arms = sorted({n[len("device.dispatch_s."):]
                   for n in series if n.startswith("device.dispatch_s.")})
    for arm in arms:
        s_ = (tail_vals(series, f"device.dispatch_s.{arm}") or [0.0])[-1]
        d_ = (tail_vals(series, f"device.dispatches.{arm}") or [0.0])[-1]
        c_ = (tail_vals(series, f"device.compiles.{arm}") or [0.0])[-1]
        print(f"  {arm:18s} = {s_:.3f}s over {d_:.0f} dispatches "
              f"({c_:.0f} fresh compiles)")
    kc = tail_vals(series, "device.kernel_cache_entries")
    if kc:
        print(f"  kernel caches      = {kc[-1]:.0f} entries")
    mb = tail_vals(series, "device.mirror_bytes")
    if mb:
        print(f"  device mirror      = {mb[-1] / 1024.0:.0f} KiB")
    # compiled feasibility economics (feas.* gauges)
    fi = tail_vals(series, "feas.intern_values")
    if fi:
        fm = (tail_vals(series, "feas.mask_cache_entries") or [0.0])[-1]
        fh = (tail_vals(series, "feas.mask_cache_hit_rate")
              or [0.0])[-1]
        fr = (tail_vals(series, "feas.recompiles") or [0.0])[-1]
        print(f"  feasibility        = {fi[-1]:.0f} interned values, "
              f"{fm:.0f} cached masks")
        print(f"  feas mask cache    = {fh:.1%} hit rate "
              f"({fr:.0f} recompiles)")
        # residue economics: device-resident tokens that
        # outlived CSI/preferred-node mutations vs dense re-uploads,
        # plus accumulated scatter debt and vectorized scoring builds
        ts_ = (tail_vals(series, "feas.token_survivals") or [0.0])[-1]
        ti_ = (tail_vals(series, "feas.token_invalidations")
               or [0.0])[-1]
        rr_ = (tail_vals(series, "feas.residue_rows") or [0.0])[-1]
        se_ = (tail_vals(series, "feas.spread_score_evals")
               or [0.0])[-1]
        if ts_ or ti_ or rr_ or se_:
            print(f"  feas residue       = {ts_:.0f} token survivals, "
                  f"{ti_:.0f} invalidations")
            print(f"  residue debt       = {rr_:.0f} scatter rows, "
                  f"{se_:.0f} vector spread evals")
    # mesh block: sharded residency economics (present only when a
    # mesh dispatcher exists — the device.mesh_* family)
    md = tail_vals(series, "device.mesh_devices")
    if md and md[-1] > 0:
        rb = (tail_vals(series,
                        "device.mesh_resident_bytes_per_device")
              or [0.0])[-1]
        ru = (tail_vals(series, "device.mesh_reshard_uploads")
              or [0.0])[-1]
        ds = (tail_vals(series, "device.mesh_delta_scatters")
              or [0.0])[-1]
        rh = (tail_vals(series, "device.mesh_resident_hits")
              or [0.0])[-1]
        sm = (tail_vals(series, "device.mesh_stale_misses")
              or [0.0])[-1]
        print(f"  mesh               = {md[-1]:.0f} devices, "
              f"resident {rb / 1024.0:.0f} KiB/device")
        print(f"  mesh traffic       = {ru:.0f} reshard uploads, "
              f"{ds:.0f} delta scatters, {rh:.0f} resident hits "
              f"({sm:.0f} stale misses)")
    hbm = tail_vals(series, "device.hbm_bytes_in_use")
    if hbm and hbm[-1] > 0:
        print(f"  HBM in use         = {hbm[-1] / (1 << 20):.1f} MiB")
    occ = tail_vals(series, "gateway.batch_occupancy")
    if occ:
        print(f"  lane occupancy     = {occ[-1]:.2f}")

    # drift annotations: the governor's structured findings over the
    # same window the trends cover
    try:
        gov = c.governor()
    except ApiError:
        gov = {}
    drifts = [e for e in gov.get("events", [])
              if e.get("kind") in ("drift", "backpressure", "reclaim")]
    if drifts:
        print()
        print(f"Annotations ({len(drifts[-8:])}):")
        for e in drifts[-8:]:
            ts = time.strftime("%H:%M:%S",
                               time.localtime(e.get("ts", 0)))
            detail = {k: v for k, v in e.items()
                      if k not in ("ts", "kind")}
            print(f"  {ts}  {e.get('kind', ''):12s} "
                  f"{json.dumps(detail, default=str)}")
    return 0


def cmd_operator_snapshot_save(args) -> int:
    c = _client(args)
    try:
        out = c.snapshot_save()
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    with open(args.file, "w") as f:
        json.dump(out, f, default=str)
    print(f"State snapshot written to {args.file} "
          f"(index {out['index']})")
    return 0


def cmd_operator_snapshot_inspect(args) -> int:
    try:
        with open(args.file) as f:
            out = json.load(f)
    except (OSError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    tables = out.get("snapshot", {}).get("tables", {})
    rows = [[name, str(len(rows_)) if isinstance(rows_, list) else "1"]
            for name, rows_ in sorted(tables.items()) if rows_]
    print(f"Index: {out.get('index')}")
    _print_rows(rows, ["Table", "Rows"])
    return 0


def cmd_operator_snapshot_restore(args) -> int:
    c = _client(args)
    try:
        with open(args.file) as f:
            out = json.load(f)
        res = c.snapshot_restore(out["snapshot"])
    except (OSError, ValueError, KeyError, ApiError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Snapshot restored (index {res['index']})")
    return 0


def cmd_operator_autopilot_get(args) -> int:
    c = _client(args)
    print(json.dumps(c.autopilot_config(), indent=2, sort_keys=True))
    return 0


def cmd_operator_autopilot_set(args) -> int:
    c = _client(args)
    cfg = {}
    if args.cleanup_dead_servers is not None:
        cfg["CleanupDeadServers"] = \
            args.cleanup_dead_servers.lower() == "true"
    if args.dead_server_cleanup_secs is not None:
        cfg["DeadServerCleanupSecs"] = args.dead_server_cleanup_secs
    c.set_autopilot_config(cfg)
    print("Configuration updated!")
    return 0


def cmd_job_promote(args) -> int:
    """`nomad job promote` — promote the job's latest deployment
    (command/job_promote.go)."""
    c = _client(args)
    try:
        deps = c.job_deployments(args.job_id)
        active = [d for d in deps
                  if d.get("status") in ("running", "paused")]
        if not active:
            print(f"Error: no active deployment for job "
                  f"{args.job_id}", file=sys.stderr)
            return 1
        c.promote_deployment(active[0]["id"])
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Deployment {short_id(active[0]['id'])} promoted")
    return 0


def cmd_namespace_list(args) -> int:
    c = _client(args)
    rows = [[n["name"], n["description"]]
            for n in c.list_namespaces()]
    _print_rows(rows, ["Name", "Description"])
    return 0


def cmd_namespace_apply(args) -> int:
    c = _client(args)
    try:
        c.apply_namespace(args.name, description=args.description)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f'Successfully applied namespace "{args.name}"!')
    return 0


def cmd_namespace_delete(args) -> int:
    c = _client(args)
    try:
        c.delete_namespace(args.name)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f'Successfully deleted namespace "{args.name}"!')
    return 0


def cmd_namespace_status(args) -> int:
    c = _client(args)
    try:
        ns = c.get_namespace(args.name)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(ns, indent=2, sort_keys=True, default=str))
    return 0


def cmd_service_list(args) -> int:
    """nomad service list (the built-in catalog's discovery surface)."""
    c = _client(args)
    rows = [[s["ServiceName"], ",".join(s["Tags"]), str(s["Instances"])]
            for s in c.list_services(namespace=args.namespace)]
    _print_rows(rows, ["Service", "Tags", "Instances"])
    return 0


def cmd_service_info(args) -> int:
    c = _client(args)
    try:
        regs = c.get_service(args.service_name, namespace=args.namespace)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    rows = [[short_id(r["alloc_id"]), r["task_name"] or "(group)",
             f"{r['address']}:{r['port']}", r["status"]]
            for r in regs]
    _print_rows(rows, ["Alloc", "Task", "Address", "Status"])
    return 0


def cmd_event_sink_register(args) -> int:
    c = _client(args)
    out = c.upsert_event_sink(args.sink_address, sink_id=args.id or "")
    print(f"Registered sink {out['ID']}")
    return 0


def cmd_event_sink_list(args) -> int:
    c = _client(args)
    rows = [[s["ID"], s["Type"], s["Address"],
             str(s["LatestIndex"])] for s in c.list_event_sinks()]
    _print_rows(rows, ["ID", "Type", "Address", "Progress"])
    return 0


def cmd_event_sink_deregister(args) -> int:
    _client(args).delete_event_sink(args.id)
    print(f"Deregistered sink {args.id}")
    return 0


def cmd_server_members(args) -> int:
    """`nomad server members` (command/server_members.go shape) plus
    the scheduler-plane columns: per-member raft role,
    applied index, fence lag behind the leader's log, and how many
    broker evals the leader has leased to each follower."""
    c = _client(args)
    try:
        out = c._request("GET", "/v1/agent/members")
    except ApiError:
        out = c._request("GET", "/v1/operator/members")
    plane = out.get("SchedulerPlane") or {}
    members = {m["addr"]: m for m in plane.get("members") or []}
    leader = out.get("Leader", "")
    rows = []
    for addr in out.get("Members", []):
        m = members.get(addr)
        if m is None:
            rows.append([addr,
                         "leader" if addr == leader else "follower",
                         "-", "-", "-"])
            continue
        rows.append([addr, str(m.get("role")),
                     "-" if m.get("applied_index") is None
                     else str(m["applied_index"]),
                     "-" if m.get("fence_lag") is None
                     else str(m["fence_lag"]),
                     str(m.get("leased_evals", 0))])
    if not rows:
        print("single-server (dev) agent; no cluster membership")
        return 0
    _print_rows(rows, ["Address", "Role", "Applied", "FenceLag",
                       "LeasedEvals"])
    leases = plane.get("leases") or {}
    print(f"\nScheduler plane: "
          f"{'on' if plane.get('enabled') else 'off'}"
          f"  remote_dequeues={leases.get('remote_dequeues', 0)}"
          f"  remote_plans={leases.get('remote_plans', 0)}"
          f"  remote_demotions={leases.get('remote_demotions', 0)}"
          f"  leases_outstanding={leases.get('outstanding', 0)}")
    return 0


def cmd_metrics(args) -> int:
    c = _client(args)
    print(json.dumps(c.metrics(), indent=2, sort_keys=True))
    return 0


def cmd_agent_info(args) -> int:
    c = _client(args)
    print(json.dumps(c.agent_self(), indent=2, sort_keys=True,
                     default=str))
    return 0


def cmd_acl_token_self(args) -> int:
    c = _client(args)
    try:
        print(json.dumps(c.acl_token_self(), indent=2, default=str))
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


def cmd_acl_policy_info(args) -> int:
    c = _client(args)
    try:
        print(json.dumps(c.acl_policy(args.name), indent=2, default=str))
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


def cmd_acl_policy_delete(args) -> int:
    _client(args).acl_delete_policy(args.name)
    print(f"Deleted policy {args.name}")
    return 0


def cmd_acl_token_delete(args) -> int:
    _client(args).acl_delete_token(args.accessor_id)
    print(f"Deleted token {args.accessor_id}")
    return 0


def cmd_operator_raft(args) -> int:
    c = _client(args)
    out = c._request("GET", "/v1/operator/raft/configuration")
    rows = [[s.get("Address", ""), s.get("Role", ""),
             "yes" if s.get("Leader") else "no",
             str(s.get("Term", "")), str(s.get("LastLogIndex", ""))]
            for s in out.get("Servers", [])]
    _print_rows(rows, ["Address", "Role", "Leader", "Term", "LastIndex"])
    return 0


def cmd_system_gc(args) -> int:
    _client(args)._request("PUT", "/v1/system/gc")
    print("GC triggered")
    return 0


# -- acl ---------------------------------------------------------------
def cmd_acl_bootstrap(args) -> int:
    c = _client(args)
    tok = c.acl_bootstrap()
    print(f"Accessor ID = {tok['accessor_id']}")
    print(f"Secret ID   = {tok['secret_id']}")
    print(f"Type        = {tok['type']}")
    return 0


def cmd_acl_policy_apply(args) -> int:
    with open(args.file) as f:
        rules = f.read()
    _client(args).acl_upsert_policy(args.name, rules,
                                    description=args.description)
    print(f"Successfully wrote policy {args.name!r}")
    return 0


def cmd_acl_policy_list(args) -> int:
    rows = [[p["name"], p.get("description", "")]
            for p in _client(args).acl_policies()]
    _print_rows(rows, ["Name", "Description"])
    return 0


def cmd_acl_token_create(args) -> int:
    tok = _client(args).acl_create_token(
        name=args.name, type_=args.type,
        policies=args.policy or [])
    print(f"Accessor ID = {tok['accessor_id']}")
    print(f"Secret ID   = {tok['secret_id']}")
    print(f"Type        = {tok['type']}")
    print(f"Policies    = {tok['policies']}")
    return 0


def cmd_acl_token_list(args) -> int:
    rows = [[t["accessor_id"][:8], t["name"], t["type"],
             ",".join(t.get("policies", []))]
            for t in _client(args).acl_tokens()]
    _print_rows(rows, ["Accessor", "Name", "Type", "Policies"])
    return 0


DEV_TOOLING_MISSING = (
    "`dev {}` needs the {} package, which this port does not carry yet "
    "(ROADMAP queue 1 item 3)")


def cmd_dev_lint(args) -> int:
    """`nomad dev lint`: the static analyzer is not carried."""
    print(DEV_TOOLING_MISSING.format("lint", "analysis/"), file=sys.stderr)
    return 1


def cmd_dev_chaos(args) -> int:
    """`nomad dev chaos [-cell NAME]` — the scenario matrix +
    fault-injection harness (nomad_tpu_torch/chaos/): every cell is a
    seeded workload + fault schedule + invariant checks + flatness
    verdict against a real in-process server, on the CUDA card unless
    `-device cpu`; the run emits a CHAOS_rNN.json artifact and exits
    non-zero when a cell fails. Local tooling: no agent connection
    involved."""
    from ..chaos.__main__ import main as chaos_main
    argv = []
    if args.cell:
        argv += ["-cell", args.cell]
    if args.full:
        argv.append("-full")
    if args.seed is not None:
        argv += ["-seed", str(args.seed)]
    if args.list_cells:
        argv.append("-list")
    if args.output:
        argv += ["-output", args.output]
    if args.no_artifact:
        argv.append("-no-artifact")
    if args.device:
        argv += ["-device", args.device]
    return chaos_main(argv)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nomad-tpu",
                                description="TPU-native workload orchestrator")
    p.add_argument("-address", default="http://127.0.0.1:4646")
    p.add_argument("-token", default=os.environ.get("NOMAD_TOKEN", ""),
                   help="ACL token secret (env NOMAD_TOKEN)")
    p.add_argument("-region", default=os.environ.get("NOMAD_REGION", ""),
                   help="target federation region (env NOMAD_REGION)")
    sub = p.add_subparsers(dest="cmd")

    agent = sub.add_parser("agent", help="run the agent")
    agent.add_argument("-dev", action="store_true")
    agent.add_argument("-server", action="store_true")
    agent.add_argument("-client", action="store_true")
    agent.add_argument("-servers", default="",
                       help="server RPC address host:port (client mode)")
    agent.add_argument("-node-name", dest="node_name", default="")
    agent.add_argument("-http-port", dest="http_port", type=int, default=4646)
    agent.add_argument("-rpc-port", dest="rpc_port", type=int, default=4647)
    agent.add_argument("-acl-enabled", dest="acl_enabled",
                       action="store_true")
    agent.add_argument("-server-peers", dest="server_peers", default="",
                       help="comma-separated rpc addrs of ALL servers "
                            "(incl. this one) to form a raft cluster")
    agent.add_argument("-alloc-dir", dest="alloc_dir_base", default="",
                       help="base directory for alloc dirs (fs/logs)")
    agent.add_argument("-cloud-fingerprint", dest="cloud_fingerprint",
                       action="store_true",
                       help="probe AWS/GCE/Azure metadata endpoints "
                            "for platform node attributes")
    # explicit -region on the subparser: without it argparse would
    # abbreviation-match `agent ... -region X` onto -region-peer
    agent.add_argument("-region", default=argparse.SUPPRESS,
                       help="this agent's federation region")
    agent.add_argument("-region-peer", dest="region_peers",
                       action="append", default=None, metavar="NAME=ADDR",
                       help="federation peer agent, repeatable "
                            "(west=10.0.0.5:4646)")
    agent.add_argument("-authoritative-region",
                       dest="authoritative_region", default="",
                       help="region to replicate ACLs/namespaces from")
    agent.add_argument("-replication-token", dest="replication_token",
                       default="", help="ACL token used for replication "
                                        "reads in the authoritative "
                                        "region")
    agent.add_argument("-config", default="",
                       help="HCL agent config file (flags win on merge)")
    agent.add_argument("-clients", type=int, default=1)
    agent.add_argument("-num-schedulers", dest="num_schedulers", type=int,
                       default=2)
    agent.add_argument("-heartbeat-ttl", dest="heartbeat_ttl", type=float,
                       default=10.0,
                       help="seconds a node may go without a heartbeat "
                            "before the server marks it down")
    agent.add_argument("-device", default="",
                       help="where the scheduler's kernels run: the CUDA "
                            "card (default) or cpu (their plain "
                            "versions)")
    agent.set_defaults(fn=cmd_agent)

    job = sub.add_parser("job", help="job commands").add_subparsers(dest="sub")
    run = job.add_parser("run")
    run.add_argument("jobfile")
    run.add_argument("-detach", action="store_true")
    run.add_argument("-check-index", dest="check_index", type=int,
                     default=None,
                     help="enforce the job's modify index (CAS submit; "
                          "0 = job must not exist)")
    run.add_argument("-var", action="append",
                     help="variable value key=value (repeatable)")
    run.set_defaults(fn=cmd_job_run)
    status = job.add_parser("status")
    status.add_argument("job_id", nargs="?")
    status.set_defaults(fn=cmd_job_status)
    stop = job.add_parser("stop")
    stop.add_argument("job_id")
    stop.add_argument("-purge", action="store_true")
    stop.add_argument("-detach", action="store_true")
    stop.set_defaults(fn=cmd_job_stop)
    init = job.add_parser("init")
    init.add_argument("filename", nargs="?", default="example.nomad")
    init.set_defaults(fn=cmd_job_init)
    revert = job.add_parser("revert")
    revert.add_argument("job_id")
    revert.add_argument("version", type=int)
    revert.add_argument("-detach", action="store_true")
    revert.set_defaults(fn=cmd_job_revert)
    jpromote = job.add_parser("promote")
    jpromote.add_argument("job_id")
    jpromote.set_defaults(fn=cmd_job_promote)
    history = job.add_parser("history")
    history.add_argument("job_id")
    history.set_defaults(fn=cmd_job_history)
    plan = job.add_parser("plan")
    plan.add_argument("jobfile")
    plan.set_defaults(fn=cmd_job_plan)
    jdisp = job.add_parser("dispatch")
    jdisp.add_argument("job_id")
    jdisp.add_argument("-meta", action="append")
    jdisp.add_argument("-payload", default="")
    jdisp.set_defaults(fn=cmd_job_dispatch)
    jinspect = job.add_parser("inspect")
    jinspect.add_argument("job_id")
    jinspect.set_defaults(fn=cmd_job_inspect)
    jvalidate = job.add_parser("validate")
    jvalidate.add_argument("path")
    jvalidate.set_defaults(fn=cmd_job_validate)
    jeval = job.add_parser("eval")
    jeval.add_argument("job_id")
    jeval.set_defaults(fn=cmd_job_eval)
    jpf = job.add_parser("periodic-force")
    jpf.add_argument("job_id")
    jpf.set_defaults(fn=cmd_job_periodic_force)
    jse = job.add_parser("scaling-events")
    jse.add_argument("job_id")
    jse.set_defaults(fn=cmd_job_scaling_events)
    scale = job.add_parser("scale")
    scale.add_argument("job_id")
    scale.add_argument("group")
    scale.add_argument("count", type=int)
    scale.add_argument("-detach", action="store_true")
    scale.set_defaults(fn=cmd_job_scale)

    dep = sub.add_parser("deployment",
                         help="deployment commands").add_subparsers(dest="sub")
    dlist = dep.add_parser("list")
    dlist.set_defaults(fn=cmd_deployment_list)
    dstatus = dep.add_parser("status")
    dstatus.add_argument("deployment_id")
    dstatus.set_defaults(fn=cmd_deployment_status)
    dpromote = dep.add_parser("promote")
    dpromote.add_argument("deployment_id")
    dpromote.add_argument("-group", action="append")
    dpromote.add_argument("-detach", action="store_true")
    dpromote.set_defaults(fn=cmd_deployment_promote)
    dfail = dep.add_parser("fail")
    dfail.add_argument("deployment_id")
    dfail.add_argument("-detach", action="store_true")
    dfail.set_defaults(fn=cmd_deployment_fail)
    dpause = dep.add_parser("pause")
    dpause.add_argument("deployment_id")
    dpause.set_defaults(fn=cmd_deployment_pause, resume=False)
    dresume = dep.add_parser("resume")
    dresume.add_argument("deployment_id")
    dresume.set_defaults(fn=cmd_deployment_pause, resume=True)

    node = sub.add_parser("node", help="node commands").add_subparsers(dest="sub")
    nstatus = node.add_parser("status")
    nstatus.add_argument("node_id", nargs="?")
    nstatus.add_argument("-stats", action="store_true",
                         help="include live host resource usage from "
                              "the client's stats sampler")
    nstatus.set_defaults(fn=cmd_node_status)
    nelig = node.add_parser("eligibility")
    nelig.add_argument("node_id")
    nelig.add_argument("-enable", action="store_true")
    nelig.add_argument("-disable", action="store_true")
    nelig.set_defaults(fn=cmd_node_eligibility)
    ndrain = node.add_parser("drain")
    ndrain.add_argument("node_id")
    ndrain.add_argument("-enable", action="store_true")
    ndrain.add_argument("-disable", action="store_true")
    ndrain.add_argument("-deadline", type=float, default=0.0)
    ndrain.add_argument("-monitor", action="store_true",
                        help="block and report until the drain "
                             "completes")
    ndrain.set_defaults(fn=cmd_node_drain)

    alloc = sub.add_parser("alloc").add_subparsers(dest="sub")
    astatus = alloc.add_parser("status")
    astatus.add_argument("alloc_id")
    astatus.add_argument("-stats", action="store_true",
                         help="include live task-level resource usage")
    astatus.set_defaults(fn=cmd_alloc_status)
    alogs = alloc.add_parser("logs")
    alogs.add_argument("alloc_id")
    alogs.add_argument("task", nargs="?", default="")
    alogs.add_argument("-stderr", action="store_true")
    alogs.set_defaults(fn=cmd_alloc_logs)
    afs = alloc.add_parser("fs")
    afs.add_argument("alloc_id")
    afs.add_argument("path", nargs="?", default="/")
    afs.set_defaults(fn=cmd_alloc_fs)
    aexec = alloc.add_parser("exec")
    aexec.add_argument("-task", default="")
    aexec.add_argument("alloc_id")
    # REMAINDER: flag-bearing commands (`alloc exec <id> ls -l`) must
    # pass through untouched
    aexec.add_argument("cmd", nargs=argparse.REMAINDER)
    aexec.set_defaults(fn=cmd_alloc_exec)
    astop = alloc.add_parser("stop")
    astop.add_argument("alloc_id")
    astop.set_defaults(fn=cmd_alloc_stop)
    arst = alloc.add_parser("restart")
    arst.add_argument("-task", dest="task_opt", default="")
    arst.add_argument("alloc_id")
    arst.add_argument("task", nargs="?", default="")
    arst.set_defaults(fn=cmd_alloc_restart)
    asig = alloc.add_parser("signal")
    asig.add_argument("-s", dest="signal", default="SIGUSR1")
    asig.add_argument("-task", dest="task_opt", default="")
    asig.add_argument("alloc_id")
    asig.add_argument("task", nargs="?", default="")
    asig.set_defaults(fn=cmd_alloc_signal)

    ev = sub.add_parser("eval").add_subparsers(dest="sub")
    estatus = ev.add_parser("status")
    estatus.add_argument("eval_id")
    estatus.set_defaults(fn=cmd_eval_status)
    elist = ev.add_parser("list")
    elist.set_defaults(fn=cmd_eval_list)

    srv = sub.add_parser("server").add_subparsers(dest="sub")
    sinfo = srv.add_parser("info")
    sinfo.set_defaults(fn=cmd_server_info)
    smembers = srv.add_parser("members")
    smembers.set_defaults(fn=cmd_server_members)

    op = sub.add_parser("operator").add_subparsers(dest="sub")
    oraft = op.add_parser("raft-status")
    oraft.set_defaults(fn=cmd_operator_raft)
    odebug = op.add_parser("debug")
    odebug.add_argument("-duration", type=float, default=2.0,
                        help="seconds of interval captures")
    odebug.add_argument("-interval", type=float, default=1.0)
    odebug.add_argument("-output", default="",
                        help="archive path (default "
                             "nomad-debug-<ts>.tar.gz)")
    odebug.set_defaults(fn=cmd_operator_debug)
    ogov = op.add_parser("governor",
                         help="steady-state governor gauges/watermarks")
    ogov.set_defaults(fn=cmd_operator_governor)
    otop = op.add_parser("top",
                         help="live rates/trends from the telemetry "
                              "ring: evals/s, p99 trend, stage "
                              "shares, device economics, flatness")
    otop.add_argument("-n", type=int, default=120,
                      help="history samples to read (default 120)")
    otop.set_defaults(fn=cmd_operator_top)
    otrace = op.add_parser(
        "trace", help="eval flight recorder: span trees, tail "
                      "exemplars, stage percentiles")
    otrace.add_argument("-exemplars", action="store_true",
                        help="only the pinned tail-exemplar set")
    otrace.add_argument("-o", default="", choices=["", "chrome"],
                        help="chrome: trace-event JSON for "
                             "Perfetto/chrome://tracing")
    otrace.add_argument("-n", type=int, default=32,
                        help="recent traces to include (default 32)")
    otrace.add_argument("-output", default="",
                        help="write chrome output to a file instead "
                             "of stdout")
    otrace.set_defaults(fn=cmd_operator_trace)
    osave = op.add_parser("snapshot-save")
    osave.add_argument("file")
    osave.set_defaults(fn=cmd_operator_snapshot_save)
    oinspect = op.add_parser("snapshot-inspect")
    oinspect.add_argument("file")
    oinspect.set_defaults(fn=cmd_operator_snapshot_inspect)
    orestore = op.add_parser("snapshot-restore")
    orestore.add_argument("file")
    orestore.set_defaults(fn=cmd_operator_snapshot_restore)
    oaget = op.add_parser("autopilot-get-config")
    oaget.set_defaults(fn=cmd_operator_autopilot_get)
    oaset = op.add_parser("autopilot-set-config")
    oaset.add_argument("-cleanup-dead-servers",
                       dest="cleanup_dead_servers", default=None)
    oaset.add_argument("-dead-server-cleanup-secs",
                       dest="dead_server_cleanup_secs", type=float,
                       default=None)
    oaset.set_defaults(fn=cmd_operator_autopilot_set)

    scaling = sub.add_parser("scaling").add_subparsers(dest="sub")
    spl = scaling.add_parser("policy-list")
    spl.set_defaults(fn=cmd_scaling_policy_list)
    spi = scaling.add_parser("policy-info")
    spi.add_argument("policy_id")
    spi.set_defaults(fn=cmd_scaling_policy_info)

    ver = sub.add_parser("version")
    ver.set_defaults(fn=cmd_version)

    uip = sub.add_parser("ui", help="print the web UI address")
    uip.set_defaults(fn=cmd_ui)

    st = sub.add_parser("status",
                        help="cross-context id lookup (or job list)")
    st.add_argument("prefix", nargs="?", default="")
    st.set_defaults(fn=cmd_status)

    mon = sub.add_parser("monitor", help="stream agent logs")
    mon.add_argument("-log-level", dest="log_level", default="info")
    mon.set_defaults(fn=cmd_monitor)

    volume = sub.add_parser("volume").add_subparsers(dest="sub")
    vst = volume.add_parser("status")
    vst.add_argument("volume_id", nargs="?", default="")
    vst.add_argument("-namespace", default="default")
    vst.set_defaults(fn=cmd_volume_status)
    vrg = volume.add_parser("register")
    vrg.add_argument("file")
    vrg.add_argument("-namespace", default="default")
    vrg.set_defaults(fn=cmd_volume_register)
    vdr = volume.add_parser("deregister")
    vdr.add_argument("volume_id")
    vdr.add_argument("-force", action="store_true")
    vdr.add_argument("-namespace", default="default")
    vdr.set_defaults(fn=cmd_volume_deregister)

    namespace = sub.add_parser("namespace").add_subparsers(dest="sub")
    nsl = namespace.add_parser("list")
    nsl.set_defaults(fn=cmd_namespace_list)
    nsa = namespace.add_parser("apply")
    nsa.add_argument("name")
    nsa.add_argument("-description", default="")
    nsa.set_defaults(fn=cmd_namespace_apply)
    nsd = namespace.add_parser("delete")
    nsd.add_argument("name")
    nsd.set_defaults(fn=cmd_namespace_delete)
    nss = namespace.add_parser("status")
    nss.add_argument("name")
    nss.set_defaults(fn=cmd_namespace_status)

    service = sub.add_parser("service").add_subparsers(dest="sub")
    svl = service.add_parser("list")
    svl.add_argument("-namespace", default="default")
    svl.set_defaults(fn=cmd_service_list)
    svi = service.add_parser("info")
    svi.add_argument("service_name")
    svi.add_argument("-namespace", default="default")
    svi.set_defaults(fn=cmd_service_info)

    event = sub.add_parser("event").add_subparsers(dest="sub")
    esr = event.add_parser("sink-register")
    esr.add_argument("sink_address")
    esr.add_argument("-id", default="")
    esr.set_defaults(fn=cmd_event_sink_register)
    esl = event.add_parser("sink-list")
    esl.set_defaults(fn=cmd_event_sink_list)
    esd = event.add_parser("sink-deregister")
    esd.add_argument("id")
    esd.set_defaults(fn=cmd_event_sink_deregister)

    metrics_p = sub.add_parser("metrics")
    metrics_p.set_defaults(fn=cmd_metrics)
    ainfo = sub.add_parser("agent-info")
    ainfo.set_defaults(fn=cmd_agent_info)

    system = sub.add_parser("system").add_subparsers(dest="sub")
    sgc = system.add_parser("gc")
    sgc.set_defaults(fn=cmd_system_gc)

    dev = sub.add_parser("dev",
                         help="developer tooling").add_subparsers(
                             dest="sub")
    dlint = dev.add_parser("lint",
                           help="TPU-hygiene static analysis "
                                "(nomad_tpu/analysis)")
    dlint.add_argument("paths", nargs="*",
                       help="files/dirs (default: the package)")
    dlint.add_argument("-json", action="store_true", dest="as_json")
    dlint.add_argument("-show-suppressed", action="store_true",
                       dest="show_suppressed")
    dlint.set_defaults(fn=cmd_dev_lint)
    dchaos = dev.add_parser("chaos",
                            help="scenario matrix + fault injection "
                                 "(nomad_tpu_torch/chaos)")
    dchaos.add_argument("-cell", default="",
                        help="comma-separated cell names (default: "
                             "all quick cells)")
    dchaos.add_argument("-full", action="store_true",
                        help="full-scale cells instead of quick")
    dchaos.add_argument("-seed", type=int, default=None)
    dchaos.add_argument("-list", action="store_true",
                        dest="list_cells")
    dchaos.add_argument("-output", default="",
                        help="artifact path (default CHAOS_rNN.json)")
    dchaos.add_argument("-no-artifact", action="store_true",
                        dest="no_artifact")
    dchaos.add_argument("-device", default=None,
                        help="where the cells' servers run: the CUDA "
                             "card by default, cpu for the CPU")
    dchaos.set_defaults(fn=cmd_dev_chaos)

    acl = sub.add_parser("acl", help="ACL policies and tokens")
    acl_sub = acl.add_subparsers(dest="acl_cmd", required=True)
    ab = acl_sub.add_parser("bootstrap")
    ab.set_defaults(fn=cmd_acl_bootstrap)
    ap_ = acl_sub.add_parser("policy-apply")
    ap_.add_argument("name")
    ap_.add_argument("file")
    ap_.add_argument("-description", default="")
    ap_.set_defaults(fn=cmd_acl_policy_apply)
    apl = acl_sub.add_parser("policy-list")
    apl.set_defaults(fn=cmd_acl_policy_list)
    atc = acl_sub.add_parser("token-create")
    atc.add_argument("-name", default="")
    atc.add_argument("-type", default="client")
    atc.add_argument("-policy", action="append")
    atc.set_defaults(fn=cmd_acl_token_create)
    atl = acl_sub.add_parser("token-list")
    atl.set_defaults(fn=cmd_acl_token_list)

    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    fn = getattr(args, "fn", None)
    if fn is None:
        parser.print_help()
        return 1
    return fn(args)


if __name__ == "__main__":
    sys.exit(main())
