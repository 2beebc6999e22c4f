"""The reference's Consul Connect model, connect admission hook and
expose-check hook tests (tests/test_consul_services.py) against the
port's models and server/connect_hook.py, their assertions unchanged;
servers on the CPU, shut down in a `finally`.

test_hcl_connect_parse (the port's jobspec/), test_upstream_env_vars
(client/taskenv) and the catalog tests on the `cluster` fixture (the
port's Client beside the Server) are at the end.

Then the port's own: a connect job registered on a server whose sidecar
driver the nodes have is placed through the kernels with its injected
proxy task and dynamic port in the group's asks.
"""

import http.server
import threading
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.models import (
    ConsulConnect,
    ConsulGateway,
    ConsulIngressListener,
    ConsulIngressService,
    ConsulProxy,
    ConsulSidecarService,
    ConsulUpstream,
    Service,
    CheckRestart,
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


# -- tests/test_consul_services.py: beside the port's Client -----------
def test_upstream_env_vars():
    from nomad_tpu_torch.client.taskenv import build_task_env
    alloc = mock.alloc()
    tg = alloc.job.task_groups[0]
    tg.services = [Service(
        name="web", port_label="http",
        connect=ConsulConnect(sidecar_service=ConsulSidecarService(
            proxy=ConsulProxy(upstreams=[
                ConsulUpstream(destination_name="count-api",
                               local_bind_port=8080)]))))]
    env = build_task_env(alloc, tg.tasks[0])
    assert env["NOMAD_UPSTREAM_ADDR_count_api"] == "127.0.0.1:8080"
    assert env["NOMAD_UPSTREAM_PORT_count_api"] == "8080"


@pytest.fixture
def cluster():
    srv = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=60.0),
                 device="cpu")
    srv.start()
    cl = Client(srv, ClientConfig(node_name="svc-node"))
    cl.start()
    yield srv, cl
    cl.shutdown()
    srv.shutdown()




def test_service_registers_and_deregisters(cluster):
    srv, _cl = cluster
    job = _service_job("catalog-job")
    srv.register_job(job)
    assert _wait(lambda: len(srv.store.service_by_name(
        "default", "web-svc")) == 1)
    reg = srv.store.service_by_name("default", "web-svc")[0]
    assert reg.port > 0                     # the scheduler's dynamic port
    assert reg.address
    assert reg.job_id == "catalog-job"
    assert reg.tags == ["urlprefix-/"]
    assert reg.status == "passing"          # no checks -> passing
    # list surface aggregates instances
    listing = srv.list_services()
    row = [r for r in listing if r["ServiceName"] == "web-svc"][0]
    assert row["Instances"] == 1

    # stop -> catalog row leaves
    srv.deregister_job("default", "catalog-job")
    assert _wait(lambda: not srv.store.service_by_name(
        "default", "web-svc"))


def test_http_check_drives_status(cluster):
    srv, _cl = cluster
    job = _service_job("checked-job", checks=[ServiceCheck(
        name="alive", type="http", path="/health", interval_s=1.0,
        timeout_s=1.0)])
    srv.register_job(job)
    assert _wait(lambda: len(srv.store.service_by_name(
        "default", "web-svc")) == 1)
    reg = srv.store.service_by_name("default", "web-svc")[0]
    # nothing is listening on the allocated port yet -> critical
    assert _wait(lambda: srv.store.service_by_name(
        "default", "web-svc")[0].status == "critical", timeout=15)

    # bring up a real listener on the allocated port -> passing
    class OK(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", reg.port), OK)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        assert _wait(lambda: srv.store.service_by_name(
            "default", "web-svc")[0].status == "passing", timeout=15)
        assert srv.store.service_by_name(
            "default", "web-svc")[0].checks["alive"] == "passing"
    finally:
        httpd.shutdown()


def test_service_gc_reaps_dead_instances(cluster):
    """A crashed client never deregisters; the leader's catalog sweep
    drops rows for terminal allocs (core_sched service GC vs Consul
    anti-entropy)."""
    from nomad_tpu_torch.models.services import ServiceRegistration
    srv, _cl = cluster
    # an orphan row pointing at an alloc that doesn't exist
    srv.update_service_registrations(upserts=[ServiceRegistration(
        id="_nomad-deadbeef-web-ghost", service_name="ghost",
        namespace="default", alloc_id="deadbeef", node_id="gone",
        address="10.0.0.9", port=1234)])
    assert srv.store.service_by_name("default", "ghost")
    from nomad_tpu_torch.models.evaluation import Evaluation
    from nomad_tpu_torch.server.core_sched import CoreScheduler
    core = CoreScheduler(srv.store.snapshot(), srv)
    core.process(Evaluation(job_id="force-gc"))
    assert _wait(lambda: not srv.store.service_by_name(
        "default", "ghost"))


def test_delete_is_namespace_and_name_scoped(cluster):
    """DELETE /v1/service/<name>/<id> only removes a row that belongs
    to that service in the caller's namespace."""
    from nomad_tpu_torch.api import HTTPApiServer, ApiClient, ApiError
    from nomad_tpu_torch.models.services import ServiceRegistration
    srv, _cl = cluster
    srv.update_service_registrations(upserts=[ServiceRegistration(
        id="_nomad-a1-g-sec", service_name="sec", namespace="secure",
        alloc_id="a1", node_id="n1", address="10.0.0.1", port=80)])
    api = HTTPApiServer(srv, port=0)
    api.start()
    try:
        c = ApiClient(f"http://127.0.0.1:{api.port}")
        # wrong namespace (default) -> 404, row survives
        with pytest.raises(ApiError):
            c.delete_service_registration("sec", "_nomad-a1-g-sec")
        assert srv.store.service_by_name("secure", "sec")
        # wrong service name in the right namespace -> 404 too
        c2 = ApiClient(f"http://127.0.0.1:{api.port}")
        with pytest.raises(ApiError):
            c2._request("DELETE", "/v1/service/other/_nomad-a1-g-sec",
                        params={"namespace": "secure"})
        # correct name+namespace deletes
        c2._request("DELETE", "/v1/service/sec/_nomad-a1-g-sec",
                    params={"namespace": "secure"})
        assert not srv.store.service_by_name("secure", "sec")
    finally:
        api.shutdown()


def test_check_restart_restarts_task(cluster):
    """check_watcher.go: limit consecutive failures -> task restart,
    visible as a restart count bump."""
    srv, cl = cluster
    job = _service_job("restarting-job", checks=[ServiceCheck(
        name="dead", type="tcp", interval_s=1.0, timeout_s=1.0,
        check_restart=CheckRestart(limit=2, grace_s=0.5))])
    srv.register_job(job)
    assert _wait(lambda: len(srv.store.service_by_name(
        "default", "web-svc")) == 1)
    aid = srv.store.service_by_name("default", "web-svc")[0].alloc_id
    assert _wait(lambda: cl.runners.get(aid) is not None
                 and all(tr.handle is not None
                         for tr in cl.runners[aid].task_runners))
    originals = {tr.task.name: id(tr.handle)
                 for tr in cl.runners[aid].task_runners}

    def restarted():
        # a forced restart consumes no budget (restarts stays 0); the
        # replacement shows as a fresh driver handle
        return any(tr.handle is not None
                   and id(tr.handle) != originals[tr.task.name]
                   for tr in cl.runners[aid].task_runners)
    assert _wait(restarted, timeout=30), "check_restart never fired"
