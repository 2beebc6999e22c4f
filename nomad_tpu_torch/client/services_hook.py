"""Client-side service registration + health checking.

Reference: the group/task service hooks push registrations into the
local Consul agent (client/allocrunner/groupservice_hook.go,
taskrunner/service_hook.go via command/agent/consul/service_client.go),
Consul runs the checks, and checkwatcher restarts tasks whose
check_restart budget is exhausted
(command/agent/consul/check_watcher.go). Here registrations go to the
server's built-in catalog over the client transport, and this hook
runs the http/tcp checks itself, reporting status transitions into the
catalog.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from ..utils.locks import make_lock
from ..models.services import (
    SERVICE_STATUS_CRITICAL,
    SERVICE_STATUS_PASSING,
    SERVICE_STATUS_PENDING,
    ServiceRegistration,
    registration_id,
)

LOG = logging.getLogger("nomad_tpu.client.services")


def _resolve_port(networks, label: str) -> int:
    for nw in networks or []:
        got = nw.port_labels().get(label)
        if got:
            return got
    return 0


def _resolve_addr(networks) -> str:
    for nw in networks or []:
        if nw.ip:
            return nw.ip
    return "127.0.0.1"


def run_check(check, address: str, port: int) -> bool:
    """One http/tcp probe (Consul's agent checks; script/grpc checks
    pass vacuously here as the reference delegates them to Consul
    features we don't model)."""
    import socket
    kind = check.type.lower()
    if kind == "tcp":
        try:
            with socket.create_connection((address, port),
                                          timeout=check.timeout_s):
                return True
        except OSError:
            return False
    if kind == "http":
        import urllib.error
        import urllib.request
        proto = check.protocol or "http"
        url = f"{proto}://{address}:{port}{check.path}"
        req = urllib.request.Request(url, method=check.method or "GET")
        try:
            with urllib.request.urlopen(req,
                                        timeout=check.timeout_s) as resp:
                return 200 <= resp.status < 300
        except (urllib.error.URLError, OSError):
            return False
    return True


class AllocServices:
    """Registers one alloc's services, runs their checks, and applies
    check_restart. Owned by the AllocRunner."""

    def __init__(self, runner, transport):
        self.runner = runner
        self.transport = transport
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._regs: Dict[str, ServiceRegistration] = {}
        self._l = make_lock()

    # -- registration --------------------------------------------------
    def _build(self) -> List[ServiceRegistration]:
        alloc = self.runner.alloc
        job = alloc.job
        tg = job.lookup_task_group(alloc.task_group) if job else None
        if tg is None:
            return []
        ar = alloc.allocated_resources
        shared_nw = ar.shared.networks if ar is not None else []
        out = []

        def mk(svc, owner: str, networks, task_name: str = ""):
            port = _resolve_port(networks, svc.port_label) \
                if svc.port_label else 0
            return ServiceRegistration(
                id=registration_id(alloc.id, owner, svc.name),
                service_name=svc.name, namespace=alloc.namespace,
                node_id=alloc.node_id, job_id=alloc.job_id,
                alloc_id=alloc.id, task_name=task_name,
                tags=list(svc.tags), address=_resolve_addr(networks),
                port=port,
                status=(SERVICE_STATUS_PENDING if svc.checks
                        else SERVICE_STATUS_PASSING),
                checks={(c.name or f"{c.type}-{i}"): SERVICE_STATUS_PENDING
                        for i, c in enumerate(svc.checks)})

        for svc in tg.services:
            out.append((svc, mk(svc, tg.name, shared_nw)))
        for task in tg.tasks:
            networks = list(shared_nw)
            if ar is not None:
                tr = ar.tasks.get(task.name)
                if tr is not None:
                    networks = list(tr.networks or []) + networks
            for svc in task.services:
                out.append((svc, mk(svc, task.name, networks, task.name)))
        return out

    def start(self) -> None:
        pairs = self._build()
        if not pairs:
            return
        regs = [r for _svc, r in pairs]
        with self._l:
            for r in regs:
                self._regs[r.id] = r
        try:
            self.transport.update_services(upserts=regs)
        except Exception:
            LOG.exception("service registration for alloc %s",
                          self.runner.alloc.id[:8])
        for svc, reg in pairs:
            for i, check in enumerate(svc.checks):
                th = threading.Thread(
                    target=self._check_loop,
                    args=(svc, check, check.name or f"{check.type}-{i}",
                          reg.id),
                    daemon=True,
                    name=f"check-{reg.service_name}")
                th.start()
                self._threads.append(th)

    def stop(self) -> None:
        """Deregister everything this alloc owns (groupservice_hook
        Postrun)."""
        self._stop.set()
        try:
            self.transport.update_services(
                delete_alloc_ids=[self.runner.alloc.id])
        except Exception:
            LOG.exception("service deregistration for alloc %s",
                          self.runner.alloc.id[:8])

    # -- checks --------------------------------------------------------
    def _check_loop(self, svc, check, check_name: str,
                    reg_id: str) -> None:
        """Poll one check; push status transitions; count consecutive
        failures against check_restart.limit after the grace window
        (check_watcher.go apply)."""
        grace_until = time.time() + (
            check.check_restart.grace_s
            if check.check_restart is not None else 0.0)
        fails = 0
        # test-friendly floor mirrors the restart-policy cap elsewhere
        interval = max(0.2, min(check.interval_s, 10.0))
        while not self._stop.is_set():
            with self._l:
                reg = self._regs.get(reg_id)
            if reg is None:
                return
            port = reg.port
            if check.port_label:
                alloc = self.runner.alloc
                ar = alloc.allocated_resources
                networks = list(ar.shared.networks) if ar else []
                got = _resolve_port(networks, check.port_label)
                if got:
                    port = got
            ok = run_check(check, reg.address, port)
            self._apply_status(reg_id, check_name,
                               SERVICE_STATUS_PASSING if ok
                               else SERVICE_STATUS_CRITICAL)
            cr = check.check_restart
            if ok:
                fails = 0
            elif cr is not None and cr.limit > 0 and \
                    time.time() >= grace_until:
                fails += 1
                if fails >= cr.limit:
                    LOG.warning("check %s unhealthy %dx; restarting "
                                "task", check_name, fails)
                    self._restart_task(svc)
                    fails = 0
                    grace_until = time.time() + cr.grace_s
            if self._stop.wait(interval):
                return

    def _apply_status(self, reg_id: str, check_name: str,
                      status: str) -> None:
        with self._l:
            reg = self._regs.get(reg_id)
            if reg is None:
                return
            if reg.checks.get(check_name) == status:
                return
            reg.checks[check_name] = status
            agg = SERVICE_STATUS_PASSING
            if any(s == SERVICE_STATUS_CRITICAL
                   for s in reg.checks.values()):
                agg = SERVICE_STATUS_CRITICAL
            elif any(s == SERVICE_STATUS_PENDING
                     for s in reg.checks.values()):
                agg = SERVICE_STATUS_PENDING
            reg.status = agg
            from dataclasses import replace
            snapshot = replace(reg, tags=list(reg.tags),
                               checks=dict(reg.checks))
        try:
            self.transport.update_services(upserts=[snapshot])
        except Exception:
            LOG.exception("service status update %s", reg_id[:16])

    def _restart_task(self, svc) -> None:
        """checkRestarter.apply: restart the backing task (group
        services restart the whole alloc's tasks)."""
        targets = [tr for tr in self.runner.task_runners
                   if not svc.task_name or tr.task.name == svc.task_name]
        for tr in targets:
            h = tr.handle
            if h is None:
                continue
            tr._force_restart = True
            try:
                tr.driver.stop_task(h, 5.0)
            except Exception:
                tr._force_restart = False
