"""The reference's federation suite (tests/test_federation.py) against the
port's replication (server/replication.py), the HTTP API's region
forwarding, the agent's region flags and the port's Client on its
`federation` fixture, servers on the CPU, assertions unchanged.

The reference's docstring:

Multi-region federation (scoped): region-keyed request forwarding.

Reference: nomad/rpc.go forward:502 — a request stamped with a foreign
region forwards to that region's servers (forwardRegion:638); each
region is its own raft domain with its own state and ACLs. Here the
agent's HTTP layer proxies foreign-region requests to the peer
region's agent wholesale.
"""

import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.server import Server as _Server
from nomad_tpu_torch import mock
from nomad_tpu_torch.api import ApiClient, ApiError, HTTPApiServer
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.server import ServerConfig


def Server(config=None, **kw):
    # the port's Server on the CPU: the kernels' plain versions
    return _Server(config, device="cpu", **kw)


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


@pytest.fixture
def federation():
    """Two regions, each a dev server+client+agent, cross-wired."""
    east_srv = Server(ServerConfig(num_schedulers=2, region="east",
                                   heartbeat_ttl_s=60.0))
    west_srv = Server(ServerConfig(num_schedulers=2, region="west",
                                   heartbeat_ttl_s=60.0))
    east_srv.start()
    west_srv.start()
    east_cl = Client(east_srv, ClientConfig(node_name="east-node"))
    west_cl = Client(west_srv, ClientConfig(node_name="west-node"))
    east_cl.start()
    west_cl.start()
    east_api = HTTPApiServer(east_srv, port=0)
    west_api = HTTPApiServer(west_srv, port=0)
    east_api.start()
    west_api.start()
    east_api.region_peers["west"] = f"127.0.0.1:{west_api.port}"
    west_api.region_peers["east"] = f"127.0.0.1:{east_api.port}"
    yield east_srv, west_srv, east_api, west_api
    for x in (east_api, west_api):
        x.shutdown()
    for x in (east_cl, west_cl):
        x.shutdown()
    for x in (east_srv, west_srv):
        x.shutdown()


def _job(job_id):
    job = mock.batch_job()
    job.id = job_id
    tg = job.task_groups[0]
    tg.count = 1
    tg.tasks[0].config = {"run_for": "30s"}
    tg.tasks[0].resources.networks = []
    tg.networks = []
    return job


def test_foreign_region_requests_forward(federation):
    east_srv, west_srv, east_api, west_api = federation
    east = ApiClient(f"http://127.0.0.1:{east_api.port}")
    # the same agent, addressed at the OTHER region
    east_to_west = ApiClient(f"http://127.0.0.1:{east_api.port}",
                             region="west")

    from nomad_tpu_torch.utils.codec import to_wire
    east.register_job(to_wire(_job("east-job")))
    east_to_west.register_job(to_wire(_job("west-job")))

    # each job landed in ITS region's state, scheduled by that region
    assert east_srv.store.job_by_id("default", "east-job") is not None
    assert east_srv.store.job_by_id("default", "west-job") is None
    assert west_srv.store.job_by_id("default", "west-job") is not None
    assert _wait(lambda: len(
        west_srv.store.allocs_by_job("default", "west-job")) == 1)

    # reads forward too: the east agent serves west's job list
    west_jobs = {j["ID"] for j in east_to_west.list_jobs()}
    assert west_jobs == {"west-job"}
    got = east_to_west.get_job("west-job")
    assert got["id"] == "west-job"

    # node listings are per-region
    east_nodes = {n["name"] for n in east.list_nodes()}
    west_nodes = {n["name"] for n in east_to_west.list_nodes()}
    assert east_nodes == {"east-node"}
    assert west_nodes == {"west-node"}


def test_unknown_region_errors(federation):
    _e, _w, east_api, _wa = federation
    c = ApiClient(f"http://127.0.0.1:{east_api.port}", region="mars")
    with pytest.raises(ApiError) as e:
        c.list_jobs()
    assert "mars" in str(e.value)


def test_remote_status_codes_pass_through(federation):
    """A 4xx from the owning region must reach the caller as that 4xx,
    not be laundered into a local 500 (forwardRegion relays the remote
    response verbatim)."""
    _e, _w, east_api, _wa = federation
    c = ApiClient(f"http://127.0.0.1:{east_api.port}", region="west")
    with pytest.raises(ApiError) as e:
        c.register_job({"id": ""})      # fails the remote's validation
    assert e.value.status == 400


def test_blocking_query_forwards_to_owning_region(federation):
    """A foreign-region blocking query must block on the OWNING
    region's index, not stall on the local store (whose raft domain is
    unrelated)."""
    east_srv, west_srv, east_api, _wa = federation
    from nomad_tpu_torch.utils.codec import to_wire
    west = ApiClient(f"http://127.0.0.1:{east_api.port}", region="west")
    west.register_job(to_wire(_job("w-block")))
    widx = west_srv.store.latest_index()
    # east's index is far below widx; the buggy path would block the
    # full wait locally before forwarding
    assert widx > east_srv.store.latest_index()
    t0 = time.time()
    jobs = west._request("GET", "/v1/jobs",
                         params={"index": widx - 1, "wait": "10s"})
    assert time.time() - t0 < 5.0
    assert any(j["ID"] == "w-block" for j in jobs)


def test_event_stream_forwards_across_regions(federation):
    """The chunked event stream relays frame-by-frame through the
    foreign agent (stream dispatch happens after the region check)."""
    _e, west_srv, east_api, _wa = federation
    import queue
    import threading
    got: "queue.Queue" = queue.Queue()
    c = ApiClient(f"http://127.0.0.1:{east_api.port}", region="west")

    def pull():
        try:
            for batch in c.stream_events(topics=["Job:stream-job"]):
                got.put(batch)
                return
        except Exception as e:      # surfaced via the queue timeout
            got.put(e)

    th = threading.Thread(target=pull, daemon=True)
    th.start()
    time.sleep(0.5)                 # let the subscription register
    from nomad_tpu_torch.utils.codec import to_wire
    c.register_job(to_wire(_job("stream-job")))
    batch = got.get(timeout=15)
    assert isinstance(batch, dict), batch
    assert any(ev["type"] == "JobRegistered" for ev in batch["Events"])


def test_agent_region_flags_and_config(tmp_path):
    """The agent half of federation is configurable: -region /
    -region-peer flags and their HCL config equivalents reach
    ServerConfig.region and HTTPApiServer.region_peers."""
    from nomad_tpu_torch.cli.agent_config import apply_to_args, load_agent_config
    from nomad_tpu_torch.cli.main import build_parser, parse_region_peers

    p = build_parser()
    args = p.parse_args(["-region", "east", "agent", "-dev",
                         "-region-peer", "west=10.0.0.5:4646",
                         "-region-peer", "eu=10.0.1.5:4646"])
    assert args.region == "east"
    assert parse_region_peers(args.region_peers) == {
        "west": "10.0.0.5:4646", "eu": "10.0.1.5:4646"}
    with pytest.raises(ValueError):
        parse_region_peers(["oops"])

    cfg_file = tmp_path / "agent.hcl"
    cfg_file.write_text('''
region = "west"
region_peers { east = "10.0.0.1:4646" }
server { enabled = true }
''')
    cfg = load_agent_config(str(cfg_file))
    assert cfg.region == "west"
    assert cfg.region_peers == {"east": "10.0.0.1:4646"}
    args2 = p.parse_args(["agent", "-config", str(cfg_file)])
    apply_to_args(cfg, args2)
    assert args2.region == "west"
    assert parse_region_peers(args2.region_peers) == {
        "east": "10.0.0.1:4646"}


def test_acl_and_namespace_replication():
    """leader.go replicateACLPolicies:1285 / replicateNamespaces:352:
    a non-authoritative region's leader replicates policies, GLOBAL
    tokens, and namespaces from the authoritative region; local tokens
    stay regional; deletions propagate."""
    from nomad_tpu_torch.acl import AclPolicy
    from nomad_tpu_torch.models.namespace import Namespace

    east_srv = Server(ServerConfig(num_schedulers=0, region="east",
                                   heartbeat_ttl_s=60.0))
    east_srv.start()
    east_api = HTTPApiServer(east_srv, port=0)
    east_api.start()
    west_srv = Server(ServerConfig(
        num_schedulers=0, region="west", heartbeat_ttl_s=60.0,
        authoritative_region="east",
        region_peers={"east": f"127.0.0.1:{east_api.port}"}))
    west_srv.start()
    try:
        east_srv.upsert_acl_policies([AclPolicy(
            name="readonly", rules='namespace "default" '
                                   '{ policy = "read" }')])
        east_srv.upsert_namespaces([Namespace(name="shared",
                                              description="everywhere")])
        gtok = east_srv.create_acl_token(name="global-tok",
                                         policies=["readonly"],
                                         global_=True)
        east_srv.create_acl_token(name="local-tok",
                                  policies=["readonly"])

        assert _wait(lambda: west_srv.store.acl_policy("readonly")
                     is not None)
        assert _wait(lambda: west_srv.store.namespace_by_name("shared")
                     is not None)
        assert _wait(lambda: west_srv.store.acl_token_by_accessor(
            gtok.accessor_id) is not None)
        # the replicated global token carries its secret (tokens work
        # in every region)
        assert west_srv.store.acl_token_by_accessor(
            gtok.accessor_id).secret_id == gtok.secret_id
        # local tokens do NOT replicate
        time.sleep(0.5)
        locals_in_west = [t for t in west_srv.store.acl_tokens()
                          if t.name == "local-tok"]
        assert not locals_in_west

        # updates + deletions propagate
        east_srv.upsert_acl_policies([AclPolicy(
            name="readonly", rules='namespace "default" '
                                   '{ policy = "write" }')])
        assert _wait(lambda: "write" in
                     west_srv.store.acl_policy("readonly").rules)
        east_srv.delete_acl_policies(["readonly"])
        assert _wait(lambda: west_srv.store.acl_policy("readonly")
                     is None)
        east_srv.delete_namespaces(["shared"])
        assert _wait(lambda: west_srv.store.namespace_by_name("shared")
                     is None)
    finally:
        east_api.shutdown()
        for s in (east_srv, west_srv):
            s.shutdown()


def test_nonauthoritative_writes_forward_to_authoritative():
    """Namespace/ACL-policy writes against a NON-authoritative region's
    agent are proxied to the authoritative region (the reference
    forwards these RPCs) — otherwise the replicator would silently
    delete locally-created objects on its next sync."""
    east_srv = Server(ServerConfig(num_schedulers=0, region="east",
                                   heartbeat_ttl_s=60.0))
    east_srv.start()
    east_api = HTTPApiServer(east_srv, port=0)
    east_api.start()
    west_srv = Server(ServerConfig(
        num_schedulers=0, region="west", heartbeat_ttl_s=60.0,
        authoritative_region="east",
        region_peers={"east": f"127.0.0.1:{east_api.port}"}))
    west_srv.start()
    west_api = HTTPApiServer(west_srv, port=0)
    west_api.start()
    try:
        west = ApiClient(f"http://127.0.0.1:{west_api.port}")
        west.apply_namespace("team-z", description="made via west")
        # the write landed in EAST (authoritative), not west's store
        assert east_srv.store.namespace_by_name("team-z") is not None
        # ... and replication brings it back to west
        assert _wait(lambda: west_srv.store.namespace_by_name("team-z")
                     is not None)
        # ACL policy writes forward the same way
        west._request("PUT", "/v1/acl/policy/shared-pol",
                      {"rules": 'namespace "default" '
                                '{ policy = "read" }'})
        assert east_srv.store.acl_policy("shared-pol") is not None
        assert _wait(lambda: west_srv.store.acl_policy("shared-pol")
                     is not None)
    finally:
        for x in (east_api, west_api):
            x.shutdown()
        for x in (east_srv, west_srv):
            x.shutdown()


def test_multiregion_job_fans_out(federation):
    """Multiregion register (enterprise-only in the reference,
    job_endpoint.go:328): an unpinned multiregion job localizes one
    region-pinned copy per region entry; stop -global fans the
    deregister."""
    from nomad_tpu_torch.models.job import (Multiregion, MultiregionRegion,
                                      MultiregionStrategy)
    east_srv, west_srv, east_api, _wa = federation
    # the servers need each other's agent addresses for the fan-out
    east_srv.config.region_peers["west"] = \
        east_api.region_peers["west"]

    job = _job("mr-job")
    job.region = "global"
    job.datacenters = []
    job.multiregion = Multiregion(
        strategy=MultiregionStrategy(max_parallel=1),
        regions=[
            MultiregionRegion(name="east", datacenters=["dc1"],
                              meta={"reg": "e"}),
            MultiregionRegion(name="west", datacenters=["dc1"],
                              meta={"reg": "w"}),
        ])
    east_srv.register_job(job)

    assert _wait(lambda: east_srv.store.job_by_id("default", "mr-job")
                 is not None)
    assert _wait(lambda: west_srv.store.job_by_id("default", "mr-job")
                 is not None)
    je = east_srv.store.job_by_id("default", "mr-job")
    jw = west_srv.store.job_by_id("default", "mr-job")
    assert je.region == "east" and jw.region == "west"
    assert je.meta["reg"] == "e" and jw.meta["reg"] == "w"
    # both regions actually run it
    assert _wait(lambda: len(east_srv.store.allocs_by_job(
        "default", "mr-job")) == 1)
    assert _wait(lambda: len(west_srv.store.allocs_by_job(
        "default", "mr-job")) == 1)

    # stop -global fans the deregister to every region in the block
    east = ApiClient(f"http://127.0.0.1:{east_api.port}")
    east._request("DELETE", "/v1/job/mr-job",
                  params={"global": "true", "purge": "true"})
    assert _wait(lambda: east_srv.store.job_by_id("default", "mr-job")
                 is None)
    assert _wait(lambda: west_srv.store.job_by_id("default", "mr-job")
                 is None)


def test_local_region_stamp_is_served_locally(federation):
    east_srv, _w, east_api, _wa = federation
    c = ApiClient(f"http://127.0.0.1:{east_api.port}", region="east")
    from nomad_tpu_torch.utils.codec import to_wire
    c.register_job(to_wire(_job("stamped-local")))
    assert east_srv.store.job_by_id("default", "stamped-local") is not None
