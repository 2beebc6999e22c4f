"""The reference's ACL tests (tests/test_acl.py) against the port's ACL
engine (acl/acl.py), its server endpoints and the HTTP API's
enforcement, servers on the CPU, their assertions unchanged.

The reference's docstring:

ACL subsystem: policy engine, token resolution, HTTP enforcement
(reference: acl/policy.go, acl/acl.go, nomad/acl_endpoint.go,
command/agent http.go token wrapping).
"""

import pytest

from nomad_tpu_torch.acl import (ACL, AclPolicy, ParseError, compile_acl,
                                 parse_policy_rules)
from nomad_tpu_torch.api import HTTPApiServer
from nomad_tpu_torch.api.client import ApiClient, ApiError
from nomad_tpu_torch.server import Server, ServerConfig

import test_torch_select  # noqa: F401  (torch's thread cap)

DEV_RULES = """
namespace "default" { policy = "write" }
namespace "ops-*" { capabilities = ["list-jobs"] }
namespace "ops-prod" { policy = "deny" }
node { policy = "read" }
"""


# -- policy engine -----------------------------------------------------
def test_policy_parse_and_compile():
    acl = compile_acl([AclPolicy(name="dev", rules=DEV_RULES)])
    assert acl.allow_namespace_operation("default", "submit-job")
    assert acl.allow_namespace_operation("default", "list-jobs")
    assert acl.allow_namespace_operation("ops-x", "list-jobs")
    assert not acl.allow_namespace_operation("ops-x", "submit-job")
    # exact deny beats glob
    assert not acl.allow_namespace_operation("ops-prod", "list-jobs")
    assert acl.allow_node_read() and not acl.allow_node_write()
    assert not acl.allow_agent_read()
    assert not acl.is_management()


def test_policy_glob_specificity():
    """acl.go: the most specific (longest non-wildcard) glob wins."""
    rules = """
namespace "prod-*" { policy = "read" }
namespace "prod-api-*" { policy = "write" }
"""
    acl = compile_acl([AclPolicy(name="p", rules=rules)])
    assert acl.allow_namespace_operation("prod-api-1", "submit-job")
    assert not acl.allow_namespace_operation("prod-web", "submit-job")
    assert acl.allow_namespace_operation("prod-web", "read-job")


def test_policy_merge_multiple():
    a = AclPolicy(name="a", rules='namespace "default" { policy = "read" }')
    b = AclPolicy(name="b",
                  rules='namespace "default" { capabilities = '
                        '["submit-job"] }\nnode { policy = "write" }')
    acl = compile_acl([a, b])
    assert acl.allow_namespace_operation("default", "read-job")
    assert acl.allow_namespace_operation("default", "submit-job")
    assert acl.allow_node_write()


def test_policy_invalid_rules_rejected():
    with pytest.raises(ParseError):
        parse_policy_rules('namespace "x" { policy = "banana" }')
    with pytest.raises(ParseError):
        parse_policy_rules('namespace "x" { capabilities = ["fly"] }')


def test_policy_json_rules():
    parsed = parse_policy_rules(
        '{"namespace": {"default": {"policy": "read"}}}')
    acl = ACL()
    acl.merge(parsed)
    assert acl.allow_namespace_operation("default", "read-job")


# -- server endpoints + enforcement ------------------------------------
@pytest.fixture
def acl_server():
    server = Server(ServerConfig(num_schedulers=0, acl_enabled=True),
                    device="cpu")
    api = HTTPApiServer(server, port=0)
    api.start()
    yield server, api
    api.shutdown()
    server.shutdown()


def test_bootstrap_and_enforcement_e2e(acl_server):
    server, api = acl_server
    addr = f"http://127.0.0.1:{api.port}"
    anon = ApiClient(addr)

    # anonymous is denied before bootstrap too
    with pytest.raises(ApiError) as e:
        anon.list_jobs()
    assert e.value.status == 403

    boot = anon.acl_bootstrap()
    assert boot["type"] == "management"
    mgmt = ApiClient(addr, token=boot["secret_id"])

    # second bootstrap fails
    with pytest.raises(ApiError) as e:
        anon.acl_bootstrap()
    assert e.value.status == 403

    # management can do everything
    assert mgmt.list_jobs() == []
    assert mgmt.list_nodes() == []

    # write a read-only policy and mint a client token
    mgmt.acl_upsert_policy(
        "readonly", 'namespace "default" { policy = "read" }')
    assert [p["name"] for p in mgmt.acl_policies()] == ["readonly"]
    tok = mgmt.acl_create_token(name="ro", policies=["readonly"])
    ro = ApiClient(addr, token=tok["secret_id"])

    # read allowed, write denied, nodes denied
    assert ro.list_jobs() == []
    with pytest.raises(ApiError) as e:
        ro.register_job({"id": "x", "name": "x"})
    assert e.value.status == 403
    with pytest.raises(ApiError) as e:
        ro.list_nodes()
    assert e.value.status == 403

    # token introspection
    assert ro.acl_token_self()["name"] == "ro"
    # client tokens cannot manage ACLs
    with pytest.raises(ApiError) as e:
        ro.acl_create_token(name="evil", policies=["readonly"])
    assert e.value.status == 403

    # bogus secret is rejected outright
    bogus = ApiClient(addr, token="not-a-token")
    with pytest.raises(ApiError) as e:
        bogus.list_jobs()
    assert e.value.status == 403

    # token deletion revokes access
    mgmt.acl_delete_token(tok["accessor_id"])
    with pytest.raises(ApiError) as e:
        ro.list_jobs()
    assert e.value.status == 403


def test_acl_disabled_is_open(acl_server):
    server = Server(ServerConfig(num_schedulers=0, acl_enabled=False),
                    device="cpu")
    api = HTTPApiServer(server, port=0)
    api.start()
    try:
        anon = ApiClient(f"http://127.0.0.1:{api.port}")
        assert anon.list_jobs() == []
    finally:
        api.shutdown()
        server.shutdown()


def test_token_resolution_server_side(acl_server):
    server, _api = acl_server
    boot = server.bootstrap_acl()
    assert server.resolve_token(boot.secret_id).is_management()
    server.upsert_acl_policies([AclPolicy(name="dev", rules=DEV_RULES)])
    tok = server.create_acl_token(name="t", policies=["dev"])
    acl = server.resolve_token(tok.secret_id)
    assert acl.allow_namespace_operation("default", "submit-job")
    assert not acl.is_management()
    with pytest.raises(PermissionError):
        server.resolve_token("garbage")
    # anonymous: deny-all
    assert not server.resolve_token("").allow_namespace_operation(
        "default", "list-jobs")


def test_acl_state_survives_dump_restore(acl_server):
    server, _api = acl_server
    boot = server.bootstrap_acl()
    server.upsert_acl_policies([AclPolicy(name="dev", rules=DEV_RULES)])
    data = server.store.dump()

    server2 = Server(ServerConfig(num_schedulers=0, acl_enabled=True),
                     device="cpu")
    server2.store.restore(data)
    try:
        assert server2.store.acl_policy("dev") is not None
        assert server2.resolve_token(boot.secret_id).is_management()
    finally:
        server2.shutdown()
