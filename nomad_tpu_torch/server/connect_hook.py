"""Connect admission hook: inject sidecar/gateway proxy tasks.

Reference: nomad/job_endpoint_hook_connect.go — groupConnectHook:174
(mutate) + groupConnectValidate:367. Runs inside Job.Register between
canonicalize and validate. The reference injects a docker/Envoy task;
the driver and config are server-configurable here so the mesh works
with any installed driver (tests use mock).
"""

from __future__ import annotations

from typing import List, Optional

from ..models import (
    CONNECT_INGRESS_PREFIX,
    CONNECT_PROXY_PREFIX,
    CONNECT_NATIVE_PREFIX,
    Job,
)
from ..models.job import LogConfig, Task, TaskGroup, TaskLifecycleConfig
from ..models.networks import Port
from ..models.resources import Resources

# connectSidecarResources (job_endpoint_hook_connect.go:16)
SIDECAR_CPU = 250
SIDECAR_MEMORY_MB = 128

DEFAULT_SIDECAR_DRIVER = "docker"
DEFAULT_SIDECAR_CONFIG = {
    "image": "envoyproxy/envoy:v1.16.0",
    "args": ["-c", "${NOMAD_SECRETS_DIR}/envoy_bootstrap.json",
             "--disable-hot-restart"],
}


def proxy_port_label(service_name: str) -> str:
    return f"{CONNECT_PROXY_PREFIX}-{service_name}"


def _sidecar_for(tg: TaskGroup, svc_name: str) -> Optional[Task]:
    """getSidecarTaskForService:125 — match by Kind, not name."""
    want = f"{CONNECT_PROXY_PREFIX}:{svc_name}"
    for t in tg.tasks:
        if t.kind == want:
            return t
    return None


def _has_gateway_task(tg: TaskGroup, svc_name: str) -> bool:
    want = f"{CONNECT_INGRESS_PREFIX}:{svc_name}"
    return any(t.kind == want for t in tg.tasks)


def _named_task_for_native(tg: TaskGroup, svc_name: str,
                           task_name: str) -> Task:
    """getNamedTaskForNativeService:155 — empty name is inferred only
    for single-task groups."""
    if not task_name:
        if len(tg.tasks) == 1:
            return tg.tasks[0]
        raise ValueError(
            f"task for Consul Connect Native service "
            f"{tg.name}->{svc_name} is ambiguous and must be set")
    for t in tg.tasks:
        if t.name == task_name:
            return t
    raise ValueError(
        f"task {task_name} named by Consul Connect Native service "
        f"{tg.name}->{svc_name} does not exist")


def _new_connect_task(svc_name: str, driver: str, config: dict) -> Task:
    """newConnectTask:344."""
    return Task(
        name=f"{CONNECT_PROXY_PREFIX}-{svc_name}",
        kind=f"{CONNECT_PROXY_PREFIX}:{svc_name}",
        driver=driver,
        config=dict(config),
        shutdown_delay_s=5.0,
        log_config=LogConfig(max_files=2, max_file_size_mb=2),
        resources=Resources(cpu=SIDECAR_CPU, memory_mb=SIDECAR_MEMORY_MB),
        lifecycle=TaskLifecycleConfig(hook="prestart", sidecar=True),
    )


def _new_gateway_task(svc_name: str, driver: str, config: dict) -> Task:
    """newConnectGatewayTask:325."""
    return Task(
        name=f"{CONNECT_INGRESS_PREFIX}-{svc_name}",
        kind=f"{CONNECT_INGRESS_PREFIX}:{svc_name}",
        driver=driver,
        config=dict(config),
        shutdown_delay_s=5.0,
        log_config=LogConfig(max_files=2, max_file_size_mb=2),
        resources=Resources(cpu=SIDECAR_CPU, memory_mb=SIDECAR_MEMORY_MB),
    )


def connect_mutate(job: Job, sidecar_driver: str = DEFAULT_SIDECAR_DRIVER,
                   sidecar_config: Optional[dict] = None) -> None:
    """jobConnectHook.Mutate:91 — groups without networks are skipped
    here so Validate can produce the meaningful error."""
    cfg = sidecar_config if sidecar_config is not None \
        else DEFAULT_SIDECAR_CONFIG
    for tg in job.task_groups:
        if not tg.networks:
            continue
        _group_connect_mutate(job, tg, sidecar_driver, cfg)


def _group_connect_mutate(job: Job, tg: TaskGroup, driver: str,
                          cfg: dict) -> None:
    """groupConnectHook:174."""
    for service in tg.services:
        connect = service.connect
        if connect is None:
            continue
        if connect.has_sidecar():
            task = _sidecar_for(tg, service.name)
            if task is None:
                task = _new_connect_task(service.name, driver, cfg)
                # a same-named unrelated task forces a suffixed name
                if any(t.name == task.name for t in tg.tasks):
                    from ..utils.ids import generate_uuid
                    task.name = f"{task.name}-{generate_uuid()[:6]}"
                tg.tasks.append(task)
            if connect.sidecar_task is not None:
                connect.sidecar_task.merge_into(task)
            task.canonicalize(job, tg)
            # dynamic proxy port, mapped same-port into the netns
            # (To=-1 sentinel, groupConnectHook makePort)
            label = proxy_port_label(service.name)
            if not any(p.label == label
                       for p in tg.networks[0].dynamic_ports):
                tg.networks[0].dynamic_ports.append(
                    Port(label=label, to=-1))
        elif connect.is_native():
            task = _named_task_for_native(tg, service.name,
                                          service.task_name)
            task.kind = f"{CONNECT_NATIVE_PREFIX}:{service.name}"
            service.task_name = task.name
        elif connect.is_gateway():
            if not _has_gateway_task(tg, service.name):
                task = _new_gateway_task(service.name, driver, cfg)
                tg.tasks.append(task)
                task.canonicalize(job, tg)


def expose_check_mutate(job: Job) -> None:
    """jobExposeCheckHook.Mutate (job_endpoint_hook_expose_check.go:22):
    group-service checks with expose=true get an expose path on the
    sidecar proxy, generating a dynamic listener port when the check
    has no port label of its own."""
    from ..models.services import ConsulExposeConfig, ConsulExposePath
    import hashlib
    for tg in job.task_groups:
        for s in tg.services:
            for check in s.checks:
                # checkIsExposable: http/grpc with a rooted path only
                if not check.expose or \
                        check.type.lower() not in ("http", "grpc") or \
                        not check.path.startswith("/"):
                    continue
                # only the BUILT-IN proxy serves expose paths; guard
                # BEFORE any mutation or a sidecar-less service would
                # be left with an orphan port + rewritten check label
                if s.connect is None or \
                        s.connect.sidecar_service is None:
                    continue        # validate() rejects this shape
                if len(tg.networks) != 1 or \
                        tg.networks[0].mode != "bridge":
                    raise ValueError(
                        f"group {tg.name!r} must use bridge network "
                        "for exposing service check(s)")
                if not check.port_label:
                    # DETERMINISTIC label: a random suffix would make
                    # every re-register of an unchanged job look like
                    # a destructive network change
                    digest = hashlib.sha256(
                        f"{s.name}\x00{check.name}".encode()
                    ).hexdigest()[:6]
                    label = f"svc_{s.name}_ck_{digest}"
                    if not any(p.label == label
                               for p in tg.networks[0].dynamic_ports):
                        tg.networks[0].dynamic_ports.append(
                            Port(label=label, to=-1))
                    check.port_label = label
                # local service port — what the service binds INSIDE
                # the netns (structs Networks.Port: reserved ports use
                # their value, dynamic ports their `to` mapping), else
                # a literal port number
                port = 0
                for nw in tg.networks:
                    for p in nw.reserved_ports:
                        if p.label == s.port_label:
                            port = p.value
                    for p in nw.dynamic_ports:
                        if p.label == s.port_label:
                            port = p.to
                    if port > 0:
                        break
                if port <= 0:
                    try:
                        port = int(s.port_label)
                    except ValueError:
                        port = 0
                    if port <= 0:
                        raise ValueError(
                            f"unable to determine local service port "
                            f"for service check {tg.name}->{s.name}->"
                            f"{check.name}")
                ss = s.connect.sidecar_service
                if ss.proxy is None:
                    from ..models.services import ConsulProxy
                    ss.proxy = ConsulProxy()
                if ss.proxy.expose is None:
                    ss.proxy.expose = ConsulExposeConfig()
                new = ConsulExposePath(
                    path=check.path, protocol=check.type.lower(),
                    local_path_port=port,
                    listener_port=check.port_label)
                if new not in ss.proxy.expose.paths:
                    ss.proxy.expose.paths.append(new)


def expose_check_validate(job: Job) -> List[str]:
    """jobExposeCheckHook.Validate:50 — expose only on group services
    with the BUILT-IN connect proxy, in a single bridge network."""
    errs: List[str] = []
    for tg in job.task_groups:
        uses = any(c.expose for s in tg.services for c in s.checks)
        if uses:
            if len(tg.networks) != 1:
                errs.append(
                    f"group {tg.name!r} must specify one bridge "
                    "network for exposing service check(s)")
            elif tg.networks[0].mode != "bridge":
                errs.append(
                    f"group {tg.name!r} must use bridge network for "
                    "exposing service check(s)")
        for s in tg.services:
            for c in s.checks:
                if c.expose and (
                        s.connect is None
                        or s.connect.sidecar_service is None
                        or s.connect.sidecar_task is not None):
                    errs.append(
                        f"exposed service check {tg.name}->{s.name}->"
                        f"{c.name} requires use of the builtin "
                        "Connect proxy")
        for t in tg.tasks:
            for s in t.services:
                for c in s.checks:
                    if c.expose:
                        errs.append(
                            f"exposed service check {tg.name}[{t.name}]"
                            f"->{s.name}->{c.name} is not a task-group "
                            "service")
    return errs


def connect_validate(job: Job) -> List[str]:
    """jobConnectHook.Validate:110 -> groupConnectValidate:367."""
    errs: List[str] = []
    for tg in job.task_groups:
        for s in tg.services:
            connect = s.connect
            if connect is None:
                continue
            if connect.has_sidecar():
                if len(tg.networks) != 1:
                    errs.append(
                        f"Consul Connect sidecars require exactly 1 "
                        f"network, found {len(tg.networks)} in group "
                        f"{tg.name!r}")
                elif tg.networks[0].mode != "bridge":
                    errs.append(
                        f"Consul Connect sidecar requires bridge "
                        f"network, found {tg.networks[0].mode!r} in "
                        f"group {tg.name!r}")
            elif connect.is_native():
                try:
                    _named_task_for_native(tg, s.name, s.task_name)
                except ValueError as e:
                    errs.append(str(e))
            elif connect.is_gateway():
                if len(tg.networks) != 1:
                    errs.append(
                        f"Consul Connect gateways require exactly 1 "
                        f"network, found {len(tg.networks)} in group "
                        f"{tg.name!r}")
                elif tg.networks[0].mode not in ("bridge", "host"):
                    errs.append(
                        'Consul Connect Gateway service requires Task '
                        'Group with network mode of type "bridge" or '
                        '"host"')
    return errs
