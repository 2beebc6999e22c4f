"""The reference's federation tests (tests/test_federation.py) that run no
Client, against the port's replication (server/replication.py), the HTTP
API's region forwarding and the agent's region flags, servers on the
CPU, their assertions unchanged. The rest of the reference's file runs a
Client on its `federation` fixture (ROADMAP queue 1 item 5); the port's
own multiregion test is tests/test_torch_cli.py's.
"""

import time

import pytest

from nomad_tpu_torch.api import ApiClient, HTTPApiServer
from nomad_tpu_torch.server import Server, ServerConfig

import test_torch_select  # noqa: F401  (torch's thread cap)


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


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
                                   heartbeat_ttl_s=60.0), device="cpu")
    east_srv.start()
    east_api = HTTPApiServer(east_srv, port=0)
    east_api.start()
    west_srv = Server(ServerConfig(
        num_schedulers=0, region="west", heartbeat_ttl_s=60.0,
        authoritative_region="east",
        region_peers={"east": f"127.0.0.1:{east_api.port}"}), device="cpu")
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
                                   heartbeat_ttl_s=60.0), device="cpu")
    east_srv.start()
    east_api = HTTPApiServer(east_srv, port=0)
    east_api.start()
    west_srv = Server(ServerConfig(
        num_schedulers=0, region="west", heartbeat_ttl_s=60.0,
        authoritative_region="east",
        region_peers={"east": f"127.0.0.1:{east_api.port}"}), device="cpu")
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
