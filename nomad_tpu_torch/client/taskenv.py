"""Task environment construction and interpolation.

Reference: client/taskenv/env.go — the NOMAD_* variable set (alloc,
task, job identity; resource limits; ADDR_/IP_/PORT_ port mappings;
META_ both as-written and upper-cased), plus ${...} interpolation over
node attributes/meta and the environment itself, used by driver configs
and templates (client/taskenv/env.go NewTaskEnv/ReplaceEnv).
"""

from __future__ import annotations

import re
from typing import Dict, Optional

_VAR = re.compile(r"\$\{([^}]+)\}")


def build_task_env(alloc, task, node=None,
                   alloc_dir: str = "", task_dir: str = "",
                   secrets_dir: str = "") -> Dict[str, str]:
    """The NOMAD_* env map for one task instance (env.go buildEnv)."""
    env: Dict[str, str] = {}
    job = alloc.job
    env["NOMAD_ALLOC_ID"] = alloc.id
    env["NOMAD_SHORT_ALLOC_ID"] = alloc.id[:8]
    env["NOMAD_ALLOC_NAME"] = alloc.name
    env["NOMAD_ALLOC_INDEX"] = str(alloc.index())
    env["NOMAD_GROUP_NAME"] = alloc.task_group
    env["NOMAD_TASK_NAME"] = task.name
    env["NOMAD_NAMESPACE"] = alloc.namespace
    if job is not None:
        env["NOMAD_JOB_ID"] = job.id
        env["NOMAD_JOB_NAME"] = job.name
        if job.parent_id:
            env["NOMAD_JOB_PARENT_ID"] = job.parent_id
        env["NOMAD_REGION"] = getattr(job, "region", "") or "global"
    env["NOMAD_DC"] = node.datacenter if node is not None else ""
    if alloc_dir:
        env["NOMAD_ALLOC_DIR"] = alloc_dir
    if task_dir:
        env["NOMAD_TASK_DIR"] = task_dir
    if secrets_dir:
        env["NOMAD_SECRETS_DIR"] = secrets_dir

    env["NOMAD_CPU_LIMIT"] = str(task.resources.cpu)
    env["NOMAD_MEMORY_LIMIT"] = str(task.resources.memory_mb)

    # meta: job < group < task precedence, exported as-written AND
    # upper-cased (env.go:823)
    meta: Dict[str, str] = {}
    if job is not None:
        meta.update(job.meta or {})
        tg = job.lookup_task_group(alloc.task_group)
        if tg is not None:
            meta.update(tg.meta or {})
    meta.update(task.meta or {})
    for k, v in meta.items():
        env[f"NOMAD_META_{k}"] = str(v)
        env[f"NOMAD_META_{k.upper()}"] = str(v)

    # network: ADDR_/IP_/PORT_<task>_<label> from allocated resources
    res = alloc.allocated_resources
    if res is not None:
        for tname, tr in res.tasks.items():
            for nw in tr.networks:
                for p in list(nw.reserved_ports) + list(nw.dynamic_ports):
                    label = f"{tname}_{p.label}"
                    env[f"NOMAD_IP_{label}"] = nw.ip
                    env[f"NOMAD_PORT_{label}"] = str(p.value)
                    env[f"NOMAD_ADDR_{label}"] = f"{nw.ip}:{p.value}"
        shared = getattr(res, "shared", None)
        if shared is not None:
            for nw in shared.networks or []:
                for p in list(nw.reserved_ports) + list(nw.dynamic_ports):
                    env[f"NOMAD_IP_{p.label}"] = nw.ip
                    env[f"NOMAD_PORT_{p.label}"] = str(p.value)
                    env[f"NOMAD_ADDR_{p.label}"] = f"{nw.ip}:{p.value}"

    # connect upstream bindings (env.go AddUpstreams:
    # NOMAD_UPSTREAM_{IP,PORT,ADDR}_<service>): the sidecar proxy
    # listens on localhost:<local_bind_port> for each upstream
    if job is not None:
        tg = job.lookup_task_group(alloc.task_group)
        for svc in (tg.services if tg is not None else []):
            cn = svc.connect
            if cn is None or cn.sidecar_service is None or \
                    cn.sidecar_service.proxy is None:
                continue
            for up in cn.sidecar_service.proxy.upstreams:
                key = up.destination_name.replace("-", "_")
                env[f"NOMAD_UPSTREAM_IP_{key}"] = "127.0.0.1"
                env[f"NOMAD_UPSTREAM_PORT_{key}"] = str(up.local_bind_port)
                env[f"NOMAD_UPSTREAM_ADDR_{key}"] = \
                    f"127.0.0.1:{up.local_bind_port}"

    # user-declared env LAST so it can reference nothing but wins keys
    for k, v in (task.env or {}).items():
        env[k] = interpolate(str(v), env, node)
    return env


def interpolate(s: str, env: Dict[str, str], node=None) -> str:
    """${...} interpolation (env.go ReplaceEnv): env. / meta. / attr. /
    node.* selectors plus bare env-var names."""
    if "${" not in s:
        return s

    def sub(m: re.Match) -> str:
        key = m.group(1).strip()
        if key.startswith("env."):
            return env.get(key[4:], "")
        if node is not None:
            if key == "node.unique.id":
                return node.id
            if key == "node.datacenter":
                return node.datacenter
            if key == "node.unique.name":
                return node.name
            if key == "node.class":
                return node.node_class
            if key.startswith("attr."):
                v = node.attributes.get(key[5:])
                return "" if v is None else str(v)
            if key.startswith("meta."):
                v = node.meta.get(key[5:])
                return "" if v is None else str(v)
        return env.get(key, m.group(0))

    return _VAR.sub(sub, s)


def interpolate_config(config, env: Dict[str, str], node=None):
    """Recursively interpolate a driver config tree."""
    if isinstance(config, str):
        return interpolate(config, env, node)
    if isinstance(config, dict):
        return {k: interpolate_config(v, env, node)
                for k, v in config.items()}
    if isinstance(config, list):
        return [interpolate_config(v, env, node) for v in config]
    return config
