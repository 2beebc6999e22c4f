"""Jobspec -> Job model mapping.

Reference semantics: jobspec/parse.go (parseJob, parseGroups:xx,
parseConstraints:128, parseAffinities:217, parseSpread:301,
parseUpdate:409, parseTasks, parseResources) and the JSON jobspec
accepted by the HTTP API.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Union

from ..models import (
    Affinity, Constraint, EphemeralDisk, Job, LogConfig, MigrateStrategy,
    NetworkResource, ParameterizedJobConfig, PeriodicConfig, Port,
    ReschedulePolicy, Resources, RestartPolicy, Service, ServiceCheck,
    Spread, SpreadTarget, Task, TaskGroup, TaskLifecycleConfig,
    UpdateStrategy, VolumeRequest, VolumeMount,
)
from ..models.resources import RequestedDevice
from .hcl import parse_hcl

_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ms|s|m|h|d)")


def parse_duration_s(val: Union[str, int, float, None],
                     default: float = 0.0) -> float:
    """'1h30m' / '500ms' / 30 -> seconds."""
    if val is None:
        return default
    if isinstance(val, (int, float)):
        return float(val)
    s = str(val).strip()
    if not s:
        return default
    total = 0.0
    matched = False
    for num, unit in _DUR_RE.findall(s):
        matched = True
        total += float(num) * {"ms": 0.001, "s": 1, "m": 60, "h": 3600,
                               "d": 86400}[unit]
    if not matched:
        try:
            return float(s)
        except ValueError:
            return default
    return total


def _as_list(v) -> list:
    if v is None:
        return []
    if isinstance(v, list):
        return v
    return [v]


def _one(v):
    """HCL single-block access: a block parses as dict or [dict]."""
    if isinstance(v, list):
        return v[0] if v else None
    return v


def _labeled(v: Optional[dict]) -> List[tuple]:
    """{'name1': {...}, 'name2': {...}} or bare {...} -> [(label, body)]."""
    if v is None:
        return []
    if isinstance(v, list):
        out = []
        for item in v:
            out.extend(_labeled(item))
        return out
    if isinstance(v, dict):
        # labeled form: every value is a dict
        if v and all(isinstance(x, (dict, list)) for x in v.values()):
            out = []
            for label, body in v.items():
                for b in _as_list(body):
                    out.append((label, b))
            return out
        return [("", v)]
    return []


def _constraints(body: dict) -> List[Constraint]:
    out = []
    for c in _as_list(body.get("constraint")):
        if not isinstance(c, dict):
            continue
        operand = c.get("operator", c.get("operand", "="))
        ltarget = c.get("attribute", c.get("ltarget", ""))
        rtarget = str(c.get("value", c.get("rtarget", "")))
        # shorthand forms: distinct_hosts = true, regexp = "...", etc.
        for short in ("distinct_hosts", "distinct_property", "regexp",
                      "version", "semver", "set_contains", "is_set",
                      "is_not_set"):
            if short in c:
                operand = short
                if short in ("distinct_hosts",):
                    ltarget = ltarget or ""
                elif short in ("is_set", "is_not_set"):
                    ltarget = ltarget or str(c[short])
                elif short == "distinct_property":
                    ltarget = str(c[short])
                    rtarget = str(c.get("value", ""))
                else:
                    rtarget = str(c[short])
        out.append(Constraint(ltarget=ltarget, rtarget=rtarget,
                              operand=operand))
    return out


def _affinities(body: dict) -> List[Affinity]:
    out = []
    for a in _as_list(body.get("affinity")):
        if not isinstance(a, dict):
            continue
        operand = a.get("operator", "=")
        for short in ("regexp", "version", "semver", "set_contains",
                      "set_contains_any", "set_contains_all"):
            if short in a:
                operand = short
        out.append(Affinity(
            ltarget=a.get("attribute", ""),
            rtarget=str(a.get("value", a.get(operand, ""))),
            operand=operand,
            weight=int(a.get("weight", 50))))
    return out


def _spreads(body: dict) -> List[Spread]:
    out = []
    for s in _as_list(body.get("spread")):
        if not isinstance(s, dict):
            continue
        targets = []
        for label, t in _labeled(s.get("target")):
            targets.append(SpreadTarget(
                value=label or t.get("value", ""),
                percent=int(t.get("percent", 0))))
        out.append(Spread(attribute=s.get("attribute", ""),
                          weight=int(s.get("weight", 50)),
                          spread_target=targets))
    return out


def _network(body: dict) -> List[NetworkResource]:
    out = []
    for nw in _as_list(body.get("network")):
        if not isinstance(nw, dict):
            continue
        n = NetworkResource(mbits=int(nw.get("mbits", 0)),
                            mode=nw.get("mode", ""))
        for label, p in _labeled(nw.get("port")):
            port = Port(label=label,
                        value=int(p.get("static", 0)),
                        to=int(p.get("to", 0)))
            if port.value:
                n.reserved_ports.append(port)
            else:
                n.dynamic_ports.append(port)
        out.append(n)
    return out


def _resources(body: Optional[dict]) -> Resources:
    if not body:
        return Resources()
    r = Resources(
        cpu=int(body.get("cpu", 100)),
        memory_mb=int(body.get("memory", body.get("memory_mb", 300))),
        disk_mb=int(body.get("disk", 0)),
        networks=_network(body),
    )
    for label, d in _labeled(body.get("device")):
        r.devices.append(RequestedDevice(
            name=label or d.get("name", ""),
            count=int(d.get("count", 1)),
            constraints=_constraints(d),
            affinities=_affinities(d)))
    return r


def _connect(body: dict):
    """connect { sidecar_service { proxy { upstreams ... } } } /
    connect { native = true } / connect { gateway { ingress {...} } }
    (jobspec/parse_service.go parseConnect)."""
    from ..models.services import (
        ConsulConnect, ConsulExposeConfig, ConsulExposePath,
        ConsulGateway, ConsulIngressListener, ConsulIngressService,
        ConsulProxy, ConsulSidecarService, ConsulUpstream, SidecarTask)
    raw = body.get("connect")
    if not raw:
        return None
    cn = _one(raw)
    connect = ConsulConnect(native=bool(cn.get("native", False)))
    if "sidecar_service" in cn:
        ss = _one(cn["sidecar_service"]) or {}
        proxy = None
        if "proxy" in ss:
            pr = _one(ss["proxy"]) or {}
            upstreams = [ConsulUpstream(
                destination_name=u.get("destination_name", ""),
                local_bind_port=int(u.get("local_bind_port", 0)))
                for u in _as_list(pr.get("upstreams"))]
            expose = None
            if "expose" in pr:
                ex = _one(pr["expose"]) or {}
                expose = ConsulExposeConfig(paths=[ConsulExposePath(
                    path=p.get("path", ""),
                    protocol=p.get("protocol", ""),
                    local_path_port=int(p.get("local_path_port", 0)),
                    listener_port=p.get("listener_port", ""))
                    for p in _as_list(ex.get("path"))])
            proxy = ConsulProxy(
                local_service_address=pr.get("local_service_address", ""),
                local_service_port=int(pr.get("local_service_port", 0)),
                upstreams=upstreams, expose=expose,
                config=dict(pr.get("config", {})))
        connect.sidecar_service = ConsulSidecarService(
            tags=list(ss.get("tags", [])), port=ss.get("port", ""),
            proxy=proxy)
    if "sidecar_task" in cn:
        st = _one(cn["sidecar_task"]) or {}
        resources = None
        if "resources" in st:
            r = _one(st["resources"]) or {}
            from ..models import Resources
            resources = Resources(cpu=int(r.get("cpu", 250)),
                                  memory_mb=int(r.get("memory", 128)))
        connect.sidecar_task = SidecarTask(
            name=st.get("name", ""), driver=st.get("driver", ""),
            user=st.get("user", ""), config=dict(_one(st.get("config"))
                                                 or {}),
            env=dict(_one(st.get("env")) or {}), resources=resources,
            meta=dict(_one(st.get("meta")) or {}),
            kill_timeout_s=parse_duration_s(st["kill_timeout"], 5.0)
            if "kill_timeout" in st else None,
            shutdown_delay_s=parse_duration_s(st["shutdown_delay"], 0.0)
            if "shutdown_delay" in st else None,
            kill_signal=st.get("kill_signal", ""))
    if "gateway" in cn:
        gw = _one(cn["gateway"]) or {}
        listeners = []
        ing = _one(gw.get("ingress")) or {}
        for lst in _as_list(ing.get("listener")):
            listeners.append(ConsulIngressListener(
                port=int(lst.get("port", 0)),
                protocol=lst.get("protocol", "tcp"),
                services=[ConsulIngressService(
                    name=sv.get("name", ""),
                    hosts=list(sv.get("hosts", [])))
                    for sv in _as_list(lst.get("service"))]))
        connect.gateway = ConsulGateway(ingress_listeners=listeners)
    return connect


def _services(body: dict) -> List[Service]:
    from ..models import CheckRestart
    out = []
    for s in _as_list(body.get("service")):
        if not isinstance(s, dict):
            continue
        checks = []
        for c in _as_list(s.get("check")):
            cr = None
            if "check_restart" in c:
                crb = _one(c["check_restart"]) or {}
                cr = CheckRestart(
                    limit=int(crb.get("limit", 0)),
                    grace_s=parse_duration_s(crb.get("grace"), 1.0),
                    ignore_warnings=bool(crb.get("ignore_warnings",
                                                 False)))
            checks.append(ServiceCheck(
                name=c.get("name", ""), type=c.get("type", ""),
                path=c.get("path", ""),
                interval_s=parse_duration_s(c.get("interval"), 10.0),
                timeout_s=parse_duration_s(c.get("timeout"), 2.0),
                port_label=c.get("port", ""),
                method=c.get("method", ""),
                protocol=c.get("protocol", ""),
                expose=bool(c.get("expose", False)),
                task_name=c.get("task", ""),
                check_restart=cr))
        out.append(Service(
            name=s.get("name", ""), port_label=s.get("port", ""),
            tags=list(s.get("tags", [])), checks=checks,
            task_name=s.get("task", ""),
            meta=dict(_one(s.get("meta")) or {}),
            connect=_connect(s)))
    return out


def _task(name: str, body: dict) -> Task:
    lifecycle = None
    lc = body.get("lifecycle")
    if isinstance(lc, dict):
        lifecycle = TaskLifecycleConfig(hook=lc.get("hook", ""),
                                        sidecar=bool(lc.get("sidecar", False)))
    volume_mounts = []
    for vm in _as_list(body.get("volume_mount")):
        volume_mounts.append(VolumeMount(
            volume=vm.get("volume", ""),
            destination=vm.get("destination", ""),
            read_only=bool(vm.get("read_only", False))))
    return Task(
        name=name,
        driver=body.get("driver", ""),
        user=body.get("user", ""),
        config=dict(body.get("config", {})),
        env=dict(body.get("env", {})),
        meta=dict(body.get("meta", {})),
        kill_timeout_s=parse_duration_s(body.get("kill_timeout"), 5.0),
        kill_signal=body.get("kill_signal", ""),
        leader=bool(body.get("leader", False)),
        resources=_resources(body.get("resources")),
        constraints=_constraints(body),
        affinities=_affinities(body),
        services=_services(body),
        lifecycle=lifecycle,
        volume_mounts=volume_mounts,
    )


def _restart(body: Optional[dict]) -> Optional[RestartPolicy]:
    if not body:
        return None
    return RestartPolicy(
        attempts=int(body.get("attempts", 2)),
        interval_s=parse_duration_s(body.get("interval"), 1800.0),
        delay_s=parse_duration_s(body.get("delay"), 15.0),
        mode=body.get("mode", "fail"))


def _reschedule(body: Optional[dict]) -> Optional[ReschedulePolicy]:
    if not body:
        return None
    return ReschedulePolicy(
        attempts=int(body.get("attempts", 0)),
        interval_s=parse_duration_s(body.get("interval"), 0.0),
        delay_s=parse_duration_s(body.get("delay"), 30.0),
        delay_function=body.get("delay_function", "exponential"),
        max_delay_s=parse_duration_s(body.get("max_delay"), 3600.0),
        unlimited=bool(body.get("unlimited", "attempts" not in body)))


def _update(body: Optional[dict]) -> Optional[UpdateStrategy]:
    if not body:
        return None
    return UpdateStrategy(
        stagger_s=parse_duration_s(body.get("stagger"), 30.0),
        max_parallel=int(body.get("max_parallel", 1)),
        health_check=body.get("health_check", "checks"),
        min_healthy_time_s=parse_duration_s(body.get("min_healthy_time"), 10.0),
        healthy_deadline_s=parse_duration_s(body.get("healthy_deadline"), 300.0),
        progress_deadline_s=parse_duration_s(body.get("progress_deadline"), 600.0),
        auto_revert=bool(body.get("auto_revert", False)),
        auto_promote=bool(body.get("auto_promote", False)),
        canary=int(body.get("canary", 0)))


def _group(name: str, body: dict, job_update: Optional[dict],
           job_migrate: Optional[dict] = None) -> TaskGroup:
    tasks = [_task(label, b) for label, b in _labeled(body.get("task"))]
    ed = body.get("ephemeral_disk")
    volumes = {}
    for label, v in _labeled(body.get("volume")):
        volumes[label] = VolumeRequest(
            name=label, type=v.get("type", "host"),
            source=v.get("source", ""),
            read_only=bool(v.get("read_only", False)))
    update_body = body.get("update", job_update)
    migrate = body.get("migrate", job_migrate)
    sacd = body.get("stop_after_client_disconnect")
    scaling = body.get("scaling")
    if isinstance(scaling, dict):
        from ..models.job import Scaling
        scaling = Scaling(enabled=bool(scaling.get("enabled", True)),
                          min=int(scaling.get("min", 0)),
                          max=int(scaling.get("max", 0)),
                          policy=dict(scaling.get("policy", {})))
    else:
        scaling = None
    return TaskGroup(
        name=name,
        count=int(body.get("count", 1)),
        constraints=_constraints(body),
        affinities=_affinities(body),
        spreads=_spreads(body),
        tasks=tasks,
        meta=dict(body.get("meta", {})),
        networks=_network(body),
        services=_services(body),
        volumes=volumes,
        restart_policy=_restart(body.get("restart")),
        reschedule_policy=_reschedule(body.get("reschedule")),
        update=_update(update_body),
        scaling=scaling,
        migrate=MigrateStrategy(
            max_parallel=int(migrate.get("max_parallel", 1)),
            min_healthy_time_s=parse_duration_s(
                migrate.get("min_healthy_time"), 10.0),
            healthy_deadline_s=parse_duration_s(
                migrate.get("healthy_deadline"), 300.0),
        ) if isinstance(migrate, dict) else None,
        ephemeral_disk=EphemeralDisk(
            sticky=bool(ed.get("sticky", False)),
            size_mb=int(ed.get("size", ed.get("size_mb", 300))),
            migrate=bool(ed.get("migrate", False)),
        ) if isinstance(ed, dict) else EphemeralDisk(),
        stop_after_client_disconnect_s=(
            parse_duration_s(sacd) if sacd is not None else None),
    )


def parse_job(src: str, variables: dict = None) -> Job:
    """Parse an HCL or JSON jobspec into a canonicalized Job. HCL goes
    through the HCL2 evaluation layer (variables/locals/functions/
    dynamic blocks, jobspec2/parse.go) with caller-supplied variable
    values."""
    src = src.strip()
    if src.startswith("{"):
        data = json.loads(src)
        if "job" in data or "Job" in data:
            data = data.get("job", data.get("Job"))
        if isinstance(data, dict) and "task_groups" in data:
            # the API wire shape: decode straight into the model
            from ..utils.codec import from_wire
            job = from_wire(Job, data)
            job.canonicalize()
            return job
    else:
        from .hcl2 import evaluate
        parsed = evaluate(parse_hcl(src), variables)
        data = parsed.get("job")
        if data is None:
            raise ValueError("jobspec must contain a 'job' block")
    # labeled: {"name": {...}}
    if isinstance(data, dict) and len(data) == 1 and \
            isinstance(next(iter(data.values())), dict) and \
            "group" not in data and "task_groups" not in data:
        job_id, body = next(iter(data.items()))
    else:
        job_id, body = data.get("id", data.get("ID", "")), data
    if not isinstance(body, dict):
        raise ValueError("malformed job block")

    job_update = body.get("update")
    job_migrate = body.get("migrate")
    groups = [_group(label, b, job_update, job_migrate)
              for label, b in _labeled(body.get("group"))]

    periodic = None
    p = body.get("periodic")
    if isinstance(p, dict):
        periodic = PeriodicConfig(
            enabled=bool(p.get("enabled", True)),
            spec=p.get("cron", p.get("spec", "")),
            prohibit_overlap=bool(p.get("prohibit_overlap", False)),
            timezone=p.get("time_zone", "UTC"))
    parameterized = None
    pz = body.get("parameterized")
    if isinstance(pz, dict):
        parameterized = ParameterizedJobConfig(
            payload=pz.get("payload", "optional"),
            meta_required=list(pz.get("meta_required", [])),
            meta_optional=list(pz.get("meta_optional", [])))

    multiregion = None
    mr = _one(body.get("multiregion"))
    if isinstance(mr, dict):
        from ..models.job import (Multiregion, MultiregionRegion,
                                  MultiregionStrategy)
        strategy = None
        st = _one(mr.get("strategy"))
        if isinstance(st, dict):
            strategy = MultiregionStrategy(
                max_parallel=int(st.get("max_parallel", 0)),
                on_failure=st.get("on_failure", ""))
        regions = [MultiregionRegion(
            name=label, count=int(b.get("count", 0)),
            datacenters=list(b.get("datacenters", [])),
            meta=dict(_one(b.get("meta")) or {}))
            for label, b in _labeled(mr.get("region"))]
        multiregion = Multiregion(strategy=strategy, regions=regions)

    job = Job(
        id=job_id,
        name=body.get("name", job_id),
        region=body.get("region", "global"),
        multiregion=multiregion,
        namespace=body.get("namespace", "default"),
        type=body.get("type", "service"),
        priority=int(body.get("priority", 50)),
        all_at_once=bool(body.get("all_at_once", False)),
        datacenters=list(body.get("datacenters", [])),
        constraints=_constraints(body),
        affinities=_affinities(body),
        spreads=_spreads(body),
        update=_update(job_update),
        task_groups=groups,
        meta=dict(body.get("meta", {})),
        periodic=periodic,
        parameterized_job=parameterized,
    )
    job.canonicalize()
    return job


def parse_job_file(path: str, variables: dict = None) -> Job:
    with open(path) as f:
        return parse_job(f.read(), variables)


def job_to_spec(job: Job) -> dict:
    """Job -> wire dict (the JSON API shape)."""
    from ..utils.codec import to_wire
    return to_wire(job)
