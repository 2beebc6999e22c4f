"""The port's front door against the JAX package's, both in this process
on the CPU.

- jobspec: `parse_job` + `job_to_spec` give equal wire dicts (or the
  same error) over every HCL jobspec in the reference's jobspec, HCL2,
  Consul and CLI suites, the `job init` example and chip_smoke.py's
  agent job files, each with no variables and with the HCL2 suite's
  variable sets; `parse_hcl` and `parse_duration_s` agree too.
- ACLs: `compile_acl` answers every namespace capability, the coarse
  checks and the host-volume checks alike, over a matrix of policies ×
  namespaces × capabilities.
- Placements through HTTP: chip_smoke.py's three agent job files (a
  service job, a batch job through the K-way arm and the `${meta.rack}`
  spread job with its affinity; counts cut to 10 / 600 / 40, each
  instance 100 MHz and 64 MB) posted to each package's agent (Server +
  RpcServer + HTTPApiServer; the port's through `cli.main.start_agent`
  with `-device cpu`), with 40 seeded nodes registered over each
  agent's RPC port, give identical allocs by (name, node name) and
  identical eval statuses, seeds 1-3.
"""

import ast
import copy
import sys
import time
from pathlib import Path

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

REPO = Path(__file__).resolve().parent.parent
SUITES = ("test_jobspec.py", "test_hcl2.py", "test_consul_services.py",
          "test_cli_tranche.py", "test_api_cli.py")
VARIABLE_SETS = (None, {"image": "redis"}, {"image": "x", "count": 5},
                 {"image": "x", "bogus": 1})
SEEDS = (1, 2, 3)
NODES = 40
RACKS = 4
COUNTS = {"agent-service": 10, "agent-batch": 600, "agent-spread": 40}
# each instance's ask, cut with the counts so 40 nodes hold every job
CPU, MEMORY = 100, 64
WAIT_S = 60.0


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke
    return chip_smoke


def _snippets():
    out = []
    for name in SUITES:
        tree = ast.parse((REPO / "tests" / name).read_text())
        out += [(name, c.value) for c in ast.walk(tree)
                if isinstance(c, ast.Constant) and isinstance(c.value, str)
                and 'job "' in c.value]
    from nomad_tpu.cli.example_job import EXAMPLE_JOB
    from nomad_tpu_torch.cli.example_job import EXAMPLE_JOB as PORT_JOB
    out += [("example_job", EXAMPLE_JOB), ("example_job", PORT_JOB)]
    cs = _chip_smoke()
    out += [("chip_smoke", cs.agent_hcl(j, kind, count))
            for j, kind, count, _arm in cs.AGENT_JOBS]
    out += [("chip_smoke", cs.device_hcl("gpu-batch")),
            ("chip_smoke", cs.pinned_hcl("pinned")),
            ("chip_smoke", cs.agent_hcl("agent-service", "service", 10,
                                        not_on=cs.DEV_CLIENT))]
    return out


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:      # the same failure is part of parity
        return ("error", type(e).__name__, str(e))


def test_snippets_cover_the_suites():
    names = {n for n, _ in _snippets()}
    assert {"test_jobspec.py", "test_hcl2.py", "test_consul_services.py",
            "example_job", "chip_smoke"} <= names
    assert len(_snippets()) >= 10


@pytest.mark.parametrize("case", range(len(_snippets())))
def test_jobspec_wire_parity(case):
    from nomad_tpu.jobspec import job_to_spec as ref_spec
    from nomad_tpu.jobspec import parse_job as ref_parse
    from nomad_tpu.jobspec.hcl import parse_hcl as ref_hcl
    from nomad_tpu_torch.jobspec import job_to_spec, parse_job, parse_hcl
    _name, text = _snippets()[case]
    assert _outcome(parse_hcl, text) == _outcome(ref_hcl, text)
    for variables in VARIABLE_SETS:
        got = _outcome(lambda: job_to_spec(parse_job(
            text, variables=copy.deepcopy(variables))))
        want = _outcome(lambda: ref_spec(ref_parse(
            text, variables=copy.deepcopy(variables))))
        assert got == want, variables


def test_parse_duration_parity():
    from nomad_tpu.jobspec.parse import parse_duration_s as ref
    from nomad_tpu_torch.jobspec.parse import parse_duration_s
    for s in ("10s", "1m30s", "250ms", "2h", "1.5s", "", "bogus", 7,
              "300", None):
        assert _outcome(parse_duration_s, s, 3.0) == \
            _outcome(ref, s, 3.0), s


POLICIES = (
    'namespace "default" { policy = "write" }\n'
    'namespace "ops-*" { capabilities = ["list-jobs"] }\n'
    'namespace "ops-prod" { policy = "deny" }\n'
    'node { policy = "read" }',
    'namespace "default" { policy = "read" }',
    'namespace "*" { policy = "scale" }\nagent { policy = "write" }',
    'namespace "team-*" { capabilities = ["submit-job", "read-logs"] }\n'
    'namespace "team-a*" { policy = "deny" }\noperator { policy = "read" }',
    'host_volume "data-*" { policy = "write" }\n'
    'host_volume "data-ro" { policy = "read" }\nquota { policy = "list" }',
    '{"namespace": {"default": {"policy": "write"}}, '
    '"node": {"policy": "write"}}',
    'namespace "default" { policy = "write" }\nnode { policy = "deny" }',
    'namespace "x" { policy = "bogus" }',
    'namespace "x" { capabilities = ["no-such-cap"] }',
    '',
)
NAMESPACES = ("default", "ops-x", "ops-prod", "team-a", "team-b", "prod",
              "")
VOLUMES = ("data-1", "data-ro", "other")


def _decisions(pkg, texts):
    """Every question a compiled ACL answers, or the compile's error."""
    if pkg == "port":
        from nomad_tpu_torch.acl import AclPolicy, compile_acl
        from nomad_tpu_torch.acl.acl import VALID_NS_CAPS
    else:
        from nomad_tpu.acl import AclPolicy, compile_acl
        from nomad_tpu.acl.acl import VALID_NS_CAPS
    try:
        acl = compile_acl([AclPolicy(name=f"p{i}", rules=t)
                           for i, t in enumerate(texts)])
    except Exception as e:
        return ("error", type(e).__name__, str(e))
    caps = sorted(VALID_NS_CAPS) + ["mount-readonly", "mount-readwrite"]
    out = {(ns, cap): acl.allow_namespace_operation(ns, cap)
           for ns in NAMESPACES for cap in caps}
    out.update({("any", ns): acl.allow_namespace(ns) for ns in NAMESPACES})
    out.update({("vol", v, cap): acl.allow_host_volume_operation(v, cap)
                for v in VOLUMES for cap in caps})
    for check in ("allow_node_read", "allow_node_write",
                  "allow_agent_read", "allow_agent_write",
                  "allow_operator_read", "allow_operator_write",
                  "is_management"):
        out[check] = getattr(acl, check)()
    return out


@pytest.mark.parametrize("i", range(len(POLICIES)))
def test_acl_decision_parity_one_policy(i):
    assert _decisions("port", [POLICIES[i]]) == \
        _decisions("ref", [POLICIES[i]])


@pytest.mark.parametrize("pair", [(0, 3), (1, 2), (3, 4), (0, 6), (2, 5)])
def test_acl_decision_parity_merged(pair):
    texts = [POLICIES[k] for k in pair]
    assert _decisions("port", texts) == _decisions("ref", texts)


def test_acl_management_and_token_parity():
    from nomad_tpu.acl import ACL_MANAGEMENT as ref_mgmt
    from nomad_tpu.acl import new_token as ref_new
    from nomad_tpu_torch.acl import ACL_MANAGEMENT, new_token
    assert ACL_MANAGEMENT.allow_namespace_operation("x", "submit-job") \
        == ref_mgmt.allow_namespace_operation("x", "submit-job")
    got, want = new_token("t", "client", ["a"], True), \
        ref_new("t", "client", ["a"], True)
    assert (got.stub().keys(), got.type, got.policies, got.global_) == \
        (want.stub().keys(), want.type, want.policies, want.global_)


def _nodes(mock, seed):
    with mock.seeded_mock_ids(seed):
        nodes = [mock.node() for _ in range(NODES)]
    for i, node in enumerate(nodes):
        node.name = f"node-{i}"
        node.meta["rack"] = f"r{i % RACKS}"
        node.compute_class()
    return nodes


def _agent(port: bool):
    """(mock, codec, ApiClient, RpcClient, agent, rpc addr, http addr,
    teardown) of each package's agent: one worker, nodes that never
    miss a heartbeat."""
    if port:
        from nomad_tpu_torch import mock
        from nomad_tpu_torch.api import ApiClient
        from nomad_tpu_torch.cli.main import build_parser, start_agent
        from nomad_tpu_torch.rpc.client import RpcClient
        from nomad_tpu_torch.utils.codec import to_wire
        agent = start_agent(build_parser().parse_args(
            ["agent", "-dev", "-clients", "0", "-num-schedulers", "1",
             "-http-port", "0", "-rpc-port", "0", "-heartbeat-ttl",
             "3600", "-device", "cpu"]))
        return (mock, to_wire, ApiClient, RpcClient, agent.rpc.addr,
                f"http://127.0.0.1:{agent.api.port}", agent.shutdown)
    from nomad_tpu import mock
    from nomad_tpu.api import ApiClient, HTTPApiServer
    from nomad_tpu.rpc import RpcServer
    from nomad_tpu.rpc.client import RpcClient
    from nomad_tpu.server import Server, ServerConfig
    from nomad_tpu.utils.codec import to_wire
    server = Server(ServerConfig(num_schedulers=1, gc_safepoints=True,
                                 heartbeat_ttl_s=3600.0))
    rpc = RpcServer(server, port=0)
    server.rpc_server = rpc
    server.start()
    rpc.start()
    api = HTTPApiServer(server, port=0)
    api.start()

    def teardown():
        api.shutdown()
        rpc.shutdown()
        server.shutdown()
    return (mock, to_wire, ApiClient, RpcClient, rpc.addr,
            f"http://127.0.0.1:{api.port}", teardown)


def _place_through_http(port: bool, seed: int):
    """{job id: (sorted (alloc name, node name), eval statuses)}."""
    mod = "nomad_tpu_torch" if port else "nomad_tpu"
    jobspec = __import__(f"{mod}.jobspec", fromlist=["parse_job"])
    cs = _chip_smoke()
    mock, to_wire, ApiClient, RpcClient, rpc_addr, addr, teardown = \
        _agent(port)
    try:
        nodes = _nodes(mock, seed)
        names = {n.id: n.name for n in nodes}
        rpc = RpcClient(rpc_addr)
        try:
            for node in nodes:
                rpc.call("Node.Register", {"node": to_wire(node)})
        finally:
            rpc.close()
        c = ApiClient(addr)
        out = {}
        for job_id, kind, _count, _arm in cs.AGENT_JOBS:
            job = jobspec.parse_job(cs.agent_hcl(
                job_id, kind, COUNTS[job_id], cpu=CPU, memory=MEMORY))
            c.register_job(jobspec.job_to_spec(job))
            deadline = time.time() + WAIT_S
            while True:
                evals = c.job_evaluations(job_id)
                if evals and all(e["status"] in ("complete", "failed")
                                 for e in evals):
                    break
                assert time.time() < deadline, evals
                time.sleep(0.02)
            allocs = c.job_allocations(job_id)
            out[job_id] = (sorted((a["name"], names[a["node_id"]])
                                  for a in allocs),
                           sorted(e["status"] for e in evals))
        return out
    finally:
        teardown()


@pytest.mark.parametrize("seed", SEEDS)
def test_http_placements_parity(seed):
    got = _place_through_http(True, seed)
    want = _place_through_http(False, seed)
    for job_id, count in COUNTS.items():
        assert len(got[job_id][0]) == count, job_id
        assert got[job_id][1] == ["complete"], job_id
    assert got == want
