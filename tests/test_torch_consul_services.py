"""The reference's Consul Connect model, connect admission hook and
expose-check hook tests (tests/test_consul_services.py) against the
port's models and server/connect_hook.py, their assertions unchanged;
servers on the CPU, shut down in a `finally`.

Left for later: test_upstream_env_vars (client/taskenv, with client/)
and the catalog tests on the `cluster` fixture (a Client beside the
Server). test_hcl_connect_parse (the port's jobspec/) is at the end.

Then the port's own: a connect job registered on a server whose sidecar
driver the nodes have is placed through the kernels with its injected
proxy task and dynamic port in the group's asks.
"""

import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import (
    ConsulConnect,
    ConsulGateway,
    ConsulIngressListener,
    ConsulIngressService,
    ConsulProxy,
    ConsulSidecarService,
    ConsulUpstream,
    Service,
    ServiceCheck,
    SidecarTask,
)
from nomad_tpu_torch.models.job import Task
from nomad_tpu_torch.models.networks import NetworkResource, Port
from nomad_tpu_torch.models.resources import Resources
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.connect_hook import (connect_mutate,
                                                 connect_validate)

import test_torch_select  # noqa: F401  (torch's thread cap)


def _wait(pred, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


# -- model validation (services.go) -----------------------------------
def test_connect_must_be_exactly_one_mode():
    # TestConsulConnect_Validate
    empty = ConsulConnect()
    assert empty.validate()                     # none configured
    both = ConsulConnect(native=True,
                         sidecar_service=ConsulSidecarService())
    assert both.validate()                      # two configured
    assert not ConsulConnect(native=True).validate()
    assert not ConsulConnect(
        sidecar_service=ConsulSidecarService()).validate()
    assert not ConsulConnect(gateway=ConsulGateway(
        ingress_listeners=[ConsulIngressListener(
            port=8080, protocol="tcp",
            services=[ConsulIngressService(name="web")])])).validate()


def test_gateway_listener_validation():
    # TestConsulGateway_Validate
    bad_port = ConsulGateway(ingress_listeners=[
        ConsulIngressListener(port=0, services=[
            ConsulIngressService(name="web")])])
    assert any("port" in e for e in bad_port.validate())
    no_services = ConsulGateway(ingress_listeners=[
        ConsulIngressListener(port=9090)])
    assert any("services" in e for e in no_services.validate())


def test_upstream_validation():
    # TestConsulUpstream_Validate + duplicate detection
    proxy = ConsulProxy(upstreams=[
        ConsulUpstream(destination_name="db", local_bind_port=9000),
        ConsulUpstream(destination_name="db", local_bind_port=9000)])
    assert any("duplicate" in e for e in proxy.validate())
    assert any("port" in e for e in ConsulUpstream(
        destination_name="db").validate())


def test_service_name_and_check_validation():
    # TestService_Validate: RFC-1123 name rules, check floors
    assert not Service(name="web-frontend").validate()
    assert Service(name="-bad").validate()
    assert Service(name="x" * 64).validate()
    assert Service(name="has space").validate()
    bad_check = Service(name="ok", checks=[
        ServiceCheck(type="http", interval_s=0.1, timeout_s=2.0)])
    errs = bad_check.validate()
    assert any("path" in e for e in errs)
    assert any("interval" in e for e in errs)


def test_service_canonicalize_interpolates_name():
    # TestService_Canonicalize (services.go:450)
    s = Service(name="${JOB}-${TASKGROUP}-${TASK}-db")
    s.canonicalize("example", "cache", "redis")
    assert s.name == "example-cache-redis-db"
    base = Service(name="${BASE}")
    base.canonicalize("j", "g", "t")
    assert base.name == "j-g-t"


# -- connect admission hook (job_endpoint_hook_connect.go) ------------
def _connect_job(connect: ConsulConnect, mode="bridge"):
    job = mock.job()
    tg = job.task_groups[0]
    tg.networks = [NetworkResource(mode=mode)]
    tg.services = [Service(name="backend", port_label="http",
                           connect=connect)]
    return job


def test_sidecar_task_injected():
    # TestJobEndpointConnect_groupConnectHook
    job = _connect_job(ConsulConnect(
        sidecar_service=ConsulSidecarService()))
    n_before = len(job.task_groups[0].tasks)
    connect_mutate(job, sidecar_driver="mock", sidecar_config={})
    tg = job.task_groups[0]
    assert len(tg.tasks) == n_before + 1
    proxy = [t for t in tg.tasks if t.kind == "connect-proxy:backend"]
    assert len(proxy) == 1
    task = proxy[0]
    assert task.name == "connect-proxy-backend"
    assert task.driver == "mock"
    assert task.resources.cpu == 250
    assert task.resources.memory_mb == 128
    assert task.lifecycle.hook == "prestart" and task.lifecycle.sidecar
    # dynamic proxy port with the To=-1 netns sentinel
    ports = [p for p in tg.networks[0].dynamic_ports
             if p.label == "connect-proxy-backend"]
    assert len(ports) == 1 and ports[0].to == -1
    # idempotent: re-mutation injects nothing new
    connect_mutate(job, sidecar_driver="mock", sidecar_config={})
    assert len(tg.tasks) == n_before + 1
    assert len([p for p in tg.networks[0].dynamic_ports
                if p.label == "connect-proxy-backend"]) == 1
    assert not connect_validate(job)


def test_sidecar_task_overrides_merge():
    # TestJobEndpointConnect_groupConnectHook sidecar_task override
    job = _connect_job(ConsulConnect(
        sidecar_service=ConsulSidecarService(),
        sidecar_task=SidecarTask(
            driver="raw_exec", config={"command": "/bin/proxy"},
            resources=Resources(cpu=500, memory_mb=256),
            kill_timeout_s=17.0)))
    connect_mutate(job, sidecar_driver="mock", sidecar_config={})
    task = [t for t in job.task_groups[0].tasks
            if t.kind == "connect-proxy:backend"][0]
    assert task.driver == "raw_exec"
    assert task.config == {"command": "/bin/proxy"}
    assert task.resources.cpu == 500
    assert task.kill_timeout_s == 17.0


def test_native_kind_set_and_task_inferred():
    # TestJobEndpointConnect_getNamedTaskForNativeService
    job = _connect_job(ConsulConnect(native=True))
    connect_mutate(job, sidecar_driver="mock", sidecar_config={})
    tg = job.task_groups[0]
    assert tg.tasks[0].kind == "connect-native:backend"
    assert tg.services[0].task_name == tg.tasks[0].name

    # ambiguous with two tasks and no task_name
    job2 = _connect_job(ConsulConnect(native=True))
    tg2 = job2.task_groups[0]
    tg2.tasks.append(Task(name="other", driver="mock"))
    with pytest.raises(ValueError, match="ambiguous"):
        connect_mutate(job2, sidecar_driver="mock", sidecar_config={})

    # names a task that doesn't exist
    job3 = _connect_job(ConsulConnect(native=True))
    job3.task_groups[0].services[0].task_name = "nope"
    with pytest.raises(ValueError, match="does not exist"):
        connect_mutate(job3, sidecar_driver="mock", sidecar_config={})


def test_gateway_task_injected():
    job = _connect_job(ConsulConnect(gateway=ConsulGateway(
        ingress_listeners=[ConsulIngressListener(
            port=8080, services=[ConsulIngressService(name="web")])])))
    connect_mutate(job, sidecar_driver="mock", sidecar_config={})
    tg = job.task_groups[0]
    gw = [t for t in tg.tasks if t.kind == "connect-ingress:backend"]
    assert len(gw) == 1
    assert gw[0].name == "connect-ingress-backend"


def test_connect_validate_network_shape():
    # TestJobEndpointConnect_groupConnectSidecarValidate
    no_net = _connect_job(ConsulConnect(
        sidecar_service=ConsulSidecarService()))
    no_net.task_groups[0].networks = []
    errs = connect_validate(no_net)
    assert any("exactly 1 network" in e for e in errs)

    host_mode = _connect_job(ConsulConnect(
        sidecar_service=ConsulSidecarService()), mode="host")
    errs = connect_validate(host_mode)
    assert any("bridge" in e for e in errs)

    ok = _connect_job(ConsulConnect(
        sidecar_service=ConsulSidecarService()))
    assert not connect_validate(ok)


def test_register_job_runs_connect_hook():
    """Job.Register runs the hook: the stored job carries the injected
    sidecar task (job_endpoint.go admission pipeline)."""
    srv = Server(ServerConfig(num_schedulers=0,
                              connect_sidecar_driver="mock",
                              connect_sidecar_config={}),
                 device="cpu")
    srv.start()
    try:
        job = _connect_job(ConsulConnect(
            sidecar_service=ConsulSidecarService()))
        srv.register_job(job)
        stored = srv.store.job_by_id("default", job.id)
        assert any(t.kind == "connect-proxy:backend"
                   for t in stored.task_groups[0].tasks)
    finally:
        srv.shutdown()


# -- upstream env (taskenv env.go AddUpstreams) -----------------------


def _service_job(job_id, checks=None, count=1):
    job = mock.job()
    job.id = job_id
    job.update = None
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = [NetworkResource(
        dynamic_ports=[Port(label="http")])]
    tg.services = [Service(name="web-svc", port_label="http",
                           tags=["urlprefix-/"], checks=checks or [])]
    task = tg.tasks[0]
    task.driver = "mock_driver"
    task.config = {"run_for": "60s"}
    task.services = []
    task.resources.networks = []
    return job


def test_tcp_check_without_port_rejected():
    """services.go validateCheckPort: a tcp/http check with no port
    label anywhere fails admission instead of probing port 0."""
    srv = Server(ServerConfig(num_schedulers=0), device="cpu")
    srv.start()
    try:
        job = _service_job("no-port-check", checks=[ServiceCheck(
            name="dangling", type="tcp", interval_s=1.0, timeout_s=1.0)])
        job.task_groups[0].services[0].port_label = ""
        with pytest.raises(ValueError, match="requires a port"):
            srv.register_job(job)
    finally:
        srv.shutdown()


# -- expose-check hook (job_endpoint_hook_expose_check.go) ------------
def _expose_job(check_kwargs=None, sidecar=True, mode="bridge"):
    from nomad_tpu_torch.models.services import ConsulSidecarService
    job = mock.job()
    tg = job.task_groups[0]
    tg.networks = [NetworkResource(
        mode=mode, dynamic_ports=[Port(label="web", to=8080)])]
    tg.services = [Service(
        name="exposed", port_label="web",
        connect=ConsulConnect(
            sidecar_service=ConsulSidecarService()) if sidecar else None,
        checks=[ServiceCheck(name="api-hc", type="http", path="/health",
                             interval_s=10.0, timeout_s=2.0,
                             expose=True, **(check_kwargs or {}))])]
    for t in tg.tasks:
        t.services = []
    return job


def test_expose_check_generates_path_and_port():
    # TestJobExposeCheckHook_Mutate (expose path extrapolated; a check
    # without its own port gets a generated dynamic listener port)
    from nomad_tpu_torch.server.connect_hook import (connect_mutate,
                                                     expose_check_mutate)
    job = _expose_job()
    connect_mutate(job, sidecar_driver="mock", sidecar_config={})
    expose_check_mutate(job)
    tg = job.task_groups[0]
    svc = tg.services[0]
    paths = svc.connect.sidecar_service.proxy.expose.paths
    assert len(paths) == 1
    p = paths[0]
    assert p.path == "/health" and p.protocol == "http"
    # generated listener port label landed on the check AND the network
    assert svc.checks[0].port_label.startswith("svc_exposed_ck_")
    assert any(pt.label == svc.checks[0].port_label and pt.to == -1
               for pt in tg.networks[0].dynamic_ports)
    # DETERMINISTIC: a second build of the same spec generates the
    # same label, so re-registering an unchanged job is not a
    # destructive network change
    job2 = _expose_job()
    connect_mutate(job2, sidecar_driver="mock", sidecar_config={})
    expose_check_mutate(job2)
    assert job2.task_groups[0].services[0].checks[0].port_label == \
        svc.checks[0].port_label
    # idempotent on re-registration (containsExposePath)
    expose_check_mutate(job)
    assert len(svc.connect.sidecar_service.proxy.expose.paths) == 1
    assert len([pt for pt in tg.networks[0].dynamic_ports
                if pt.label == svc.checks[0].port_label]) == 1


def test_expose_check_skips_unexposable_and_sidecarless():
    # checkIsExposable: no rooted path -> skipped entirely; no
    # sidecar -> no half-mutation (no orphan port, label untouched)
    from nomad_tpu_torch.server.connect_hook import expose_check_mutate
    job = _expose_job()
    job.task_groups[0].services[0].checks[0].path = ""
    expose_check_mutate(job)
    assert not job.task_groups[0].services[0].checks[0].port_label
    assert all(p.label == "web"
               for p in job.task_groups[0].networks[0].dynamic_ports)

    job2 = _expose_job(sidecar=False)
    n_ports = len(job2.task_groups[0].networks[0].dynamic_ports)
    expose_check_mutate(job2)
    assert not job2.task_groups[0].services[0].checks[0].port_label
    assert len(job2.task_groups[0].networks[0].dynamic_ports) == n_ports


def test_expose_check_requires_builtin_proxy():
    # tgValidateUseOfCheckExpose: expose without connect is rejected
    from nomad_tpu_torch.server.connect_hook import expose_check_validate
    errs = expose_check_validate(_expose_job(sidecar=False))
    assert any("builtin Connect proxy" in e for e in errs)


def test_expose_check_requires_bridge():
    # tgValidateUseOfBridgeMode
    from nomad_tpu_torch.server.connect_hook import expose_check_validate
    errs = expose_check_validate(_expose_job(mode="host"))
    assert any("bridge network" in e for e in errs)


def test_expose_check_rejected_on_task_services():
    from nomad_tpu_torch.server.connect_hook import expose_check_validate
    job = _expose_job()
    tg = job.task_groups[0]
    tg.tasks[0].services = [Service(
        name="tsvc", port_label="web",
        checks=[ServiceCheck(name="t-hc", type="http", path="/x",
                             interval_s=10.0, timeout_s=2.0,
                             expose=True)])]
    errs = expose_check_validate(job)
    assert any("not a task-group service" in e for e in errs)


# -- the port's own ---------------------------------------------------
def _wait_allocs(srv, job, n, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        allocs = srv.store.allocs_by_job(job.namespace, job.id)
        if len(allocs) >= n:
            return allocs
        time.sleep(0.02)
    return srv.store.allocs_by_job(job.namespace, job.id)


def test_connect_job_places_with_its_sidecar():
    """No NotImplementedError at registration any more: with the sidecar
    driver one the nodes fingerprint, a connect job is placed like any
    other job, its proxy task and dynamic port in the group's asks."""
    srv = Server(ServerConfig(num_schedulers=1, heartbeat_ttl_s=3600.0,
                              gateway_window_us=0,
                              connect_sidecar_driver="mock_driver",
                              connect_sidecar_config={}),
                 device="cpu")
    srv.start()
    try:
        for i in range(4):
            node = mock.node()
            node.name = f"connect-node-{i}"
            srv.register_node(node)
        job = _connect_job(ConsulConnect(
            sidecar_service=ConsulSidecarService()))
        job.task_groups[0].count = 3
        srv.register_job(job)
        allocs = _wait_allocs(srv, job, 3)
        assert len(allocs) == 3
        for a in allocs:
            assert set(a.allocated_resources.tasks) == {
                "web", "connect-proxy-backend"}
            proxy = a.allocated_resources.tasks["connect-proxy-backend"]
            assert proxy.cpu.cpu_shares == 250
            assert proxy.memory.memory_mb == 128
            ports = {p.label: p.value
                     for net in a.allocated_resources.shared.networks
                     for p in net.dynamic_ports}
            assert ports.get("connect-proxy-backend", 0) > 0
    finally:
        srv.shutdown()


# -- jobspec HCL parse (the reference's) ------------------------------
def test_hcl_connect_parse():
    from nomad_tpu_torch.jobspec import parse_job
    job = parse_job('''
job "mesh" {
  group "api" {
    network { mode = "bridge" }
    service {
      name = "count-api"
      port = "9001"
      connect {
        sidecar_service {
          proxy {
            upstreams {
              destination_name = "count-db"
              local_bind_port  = 8080
            }
          }
        }
        sidecar_task {
          driver = "raw_exec"
          resources { cpu = 300  memory = 200 }
        }
      }
      check {
        name     = "alive"
        type     = "http"
        path     = "/health"
        interval = "10s"
        timeout  = "2s"
        check_restart { limit = 3  grace = "5s" }
      }
    }
    task "api" {
      driver = "mock"
      config { run_for = "10s" }
    }
  }
}
''')
    tg = job.task_groups[0]
    svc = tg.services[0]
    assert svc.name == "count-api"
    cn = svc.connect
    assert cn is not None and cn.has_sidecar()
    assert cn.sidecar_service.proxy.upstreams[0].destination_name == \
        "count-db"
    assert cn.sidecar_service.proxy.upstreams[0].local_bind_port == 8080
    assert cn.sidecar_task.driver == "raw_exec"
    assert cn.sidecar_task.resources.cpu == 300
    chk = svc.checks[0]
    assert chk.check_restart.limit == 3
    assert chk.check_restart.grace_s == 5.0
