"""The reference's CSI volume and admission-hook tests (tests/test_csi.py:
claim rules, CSI feasibility and claims through the Harness, topology,
implied constraints through Server.register_job) against the port,
their assertions unchanged, on the CPU.

Left for later: test_volume_watcher_releases_terminal_claims (its
Client launches a CSI plugin; client/csimanager.py and
plugins/csi_client.py are not ported). test_csi_http_routes (the port's
api/) and test_vault_token_derivation_and_env (the Vault token
authority) are at the end.

Then the port's own: the CSI endpoints and the volume watcher on a
server whose allocs a test marks complete as a client would.
"""

import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import CSIVolume, Evaluation, VaultConfig
from nomad_tpu_torch.models.csi import (ACCESS_MULTI_NODE_MULTI_WRITER,
                                        ACCESS_MULTI_NODE_READER,
                                        ACCESS_SINGLE_NODE_WRITER)
from nomad_tpu_torch.models.job import VolumeRequest
from nomad_tpu_torch.scheduler.harness import Harness
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.utils.ids import generate_uuid

import test_torch_select  # noqa: F401  (torch's thread cap)


def _wait_for(pred, timeout=15.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _eval_for(job):
    from nomad_tpu_torch.models import EVAL_STATUS_PENDING, TRIGGER_JOB_REGISTER
    return Evaluation(
        id=generate_uuid(), namespace=job.namespace, priority=job.priority,
        triggered_by=TRIGGER_JOB_REGISTER, job_id=job.id,
        status=EVAL_STATUS_PENDING, type=job.type)


def _csi_job(volume_source, read_only=False, count=1, name="csi-job"):
    job = mock.job()
    job.id = name
    tg = job.task_groups[0]
    tg.count = count
    for t in tg.tasks:
        t.resources.networks = []
    tg.networks = []
    tg.volumes = {"vol": VolumeRequest(
        name="vol", type="csi", source=volume_source,
        read_only=read_only)}
    return job


# -- claim semantics ---------------------------------------------------
def test_claim_capacity_rules():
    v = CSIVolume(id="v1", access_mode=ACCESS_SINGLE_NODE_WRITER)
    assert v.claimable(read_only=False)
    v.claim("a1", "n1", read_only=False)
    assert not v.claimable(read_only=False)
    assert v.release("a1")
    assert v.claimable(read_only=False)

    multi = CSIVolume(id="v2", access_mode=ACCESS_MULTI_NODE_MULTI_WRITER)
    multi.claim("a1", "n1", False)
    assert multi.claimable(read_only=False)

    reader = CSIVolume(id="v3", access_mode=ACCESS_MULTI_NODE_READER)
    assert reader.claimable(read_only=True)
    assert not reader.claimable(read_only=False)

    unsched = CSIVolume(id="v4", schedulable=False)
    assert not unsched.claimable(read_only=True)



def _csi_node():
    """A node advertising the p1 CSI plugin (the scheduler requires the
    volume's plugin on the node — feasible.go CSIVolumeChecker)."""
    n = mock.node()
    n.attributes["csi.plugin.p1"] = "1"
    n.compute_class()
    return n

# -- scheduling --------------------------------------------------------
def test_csi_feasibility_and_claim_on_placement():
    h = Harness(device="cpu")
    n = _csi_node()
    h.store.upsert_node(h.next_index(), n)

    # no volume registered: placement fails with the CSI reason
    job = _csi_job("data-vol")
    h.store.upsert_job(h.next_index(), job)
    h.process("service", _eval_for(job))
    assert h.evals and "web" in h.evals[-1].failed_tg_allocs
    metrics = h.evals[-1].failed_tg_allocs["web"]
    assert any("CSI" in k for k in metrics.constraint_filtered), \
        metrics.constraint_filtered

    # register the volume: placement succeeds and the claim lands
    vol = CSIVolume(id="data-vol", plugin_id="p1",
                    access_mode=ACCESS_SINGLE_NODE_WRITER)
    h.store.upsert_csi_volumes(h.next_index(), [vol])
    job2 = _csi_job("data-vol", name="csi-job-2")
    h.store.upsert_job(h.next_index(), job2)
    h.process("service", _eval_for(job2))
    placed = h.store.allocs_by_job("default", job2.id)
    assert len(placed) == 1
    v = h.store.csi_volume("default", "data-vol")
    assert placed[0].id in v.write_allocs

    # a second writer job can't claim the single-writer volume
    job3 = _csi_job("data-vol", name="csi-job-3")
    h.store.upsert_job(h.next_index(), job3)
    h.process("service", _eval_for(job3))
    assert h.store.allocs_by_job("default", job3.id) == []


def test_single_writer_enforced_per_placement_within_batch():
    """A count>1 group on a single-node-writer volume must not end up
    with multiple write claims from one plan: capacity is re-checked
    per placement inside the batch claim (csi.go WriteFreeClaims:385
    is per-claim, not per-plan)."""
    h = Harness(device="cpu")
    for _ in range(3):
        h.store.upsert_node(h.next_index(), _csi_node())
    vol = CSIVolume(id="solo-vol", plugin_id="p1",
                    access_mode=ACCESS_SINGLE_NODE_WRITER)
    h.store.upsert_csi_volumes(h.next_index(), [vol])
    job = _csi_job("solo-vol", count=3, name="csi-multi")
    h.store.upsert_job(h.next_index(), job)
    h.process("service", _eval_for(job))
    v = h.store.csi_volume("default", "solo-vol")
    assert len(v.write_allocs) <= 1, \
        f"single-writer volume got {len(v.write_allocs)} write claims"


def test_reads_never_claim_limited():
    """csi.go ReadSchedulable:361 checks only volume health — reads are
    allowed regardless of existing claims, in every access mode."""
    v = CSIVolume(id="v", access_mode=ACCESS_SINGLE_NODE_WRITER)
    v.claim("w1", "n1", read_only=False)
    assert v.claimable(read_only=True)
    v.claim("r1", "n1", read_only=True)
    assert v.claimable(read_only=True)
    unsched = CSIVolume(id="u", schedulable=False)
    assert not unsched.claimable(read_only=True)


def test_csi_topology_restricts_nodes():
    h = Harness(device="cpu")
    n1, n2 = _csi_node(), _csi_node()
    h.store.upsert_node(h.next_index(), n1)
    h.store.upsert_node(h.next_index(), n2)
    vol = CSIVolume(id="topo-vol", plugin_id="p1",
                    access_mode=ACCESS_SINGLE_NODE_WRITER,
                    topology_node_ids=[n2.id])
    h.store.upsert_csi_volumes(h.next_index(), [vol])
    job = _csi_job("topo-vol", name="topo-job")
    h.store.upsert_job(h.next_index(), job)
    h.process("service", _eval_for(job))
    placed = h.store.allocs_by_job("default", job.id)
    assert len(placed) == 1 and placed[0].node_id == n2.id


# -- admission hooks ---------------------------------------------------
def test_implied_constraints_vault_and_signals():
    server = Server(ServerConfig(num_schedulers=0), device="cpu")
    try:
        job = mock.job()
        task = job.task_groups[0].tasks[0]
        task.vault = VaultConfig(policies=["app"], change_signal="SIGHUP",
                                 change_mode="signal")
        server.register_job(job)
        stored = server.store.job_by_id("default", job.id)
        cons = {(c.ltarget, c.operand)
                for c in stored.task_groups[0].constraints}
        assert ("${attr.vault.version}", "is_set") in cons
        assert ("${attr.os.signals}", "set_contains") in cons
    finally:
        server.shutdown()


# -- the port's own: endpoints and the volume watcher -------------------
def test_csi_endpoints_refuse_bad_and_claimed_volumes():
    server = Server(ServerConfig(num_schedulers=0), device="cpu")
    try:
        with pytest.raises(ValueError):
            server.register_csi_volume(CSIVolume(id="no-plugin"))
        server.register_csi_volume(CSIVolume(
            id="ep-vol", plugin_id="p1",
            access_mode=ACCESS_SINGLE_NODE_WRITER))
        assert server.store.csi_volume("default", "ep-vol") is not None
        server.raft_apply("csi_volume_claim", dict(
            namespace="default", volume_id="ep-vol", alloc_id="a1",
            node_id="n1", read_only=False))
        with pytest.raises(ValueError, match="active claims"):
            server.deregister_csi_volume("default", "ep-vol")
        with pytest.raises(KeyError):
            server.deregister_csi_volume("default", "missing")
        server.deregister_csi_volume("default", "ep-vol", force=True)
        assert server.store.csi_volume("default", "ep-vol") is None
    finally:
        server.shutdown()


def test_volume_watcher_releases_claims_of_terminal_allocs():
    """The watcher thread releases a claim once its alloc is terminal,
    and shutdown joins it without waiting out its one-second pass."""
    from dataclasses import replace
    server = Server(ServerConfig(num_schedulers=1, heartbeat_ttl_s=3600.0,
                                 gateway_window_us=0), device="cpu")
    server.start()
    try:
        server.register_node(_csi_node())
        server.register_csi_volume(CSIVolume(
            id="batch-vol", plugin_id="p1",
            access_mode=ACCESS_SINGLE_NODE_WRITER))
        job = _csi_job("batch-vol", name="csi-batch")
        job.type = "batch"
        server.register_job(job)
        assert _wait_for(lambda: len(
            server.store.allocs_by_job("default", job.id)) == 1)
        assert len(server.store.csi_volume(
            "default", "batch-vol").write_allocs) == 1
        alloc = server.store.allocs_by_job("default", job.id)[0]
        server.update_alloc_status_from_client(
            [replace(alloc, client_status="complete")])
        assert _wait_for(lambda: len(server.store.csi_volume(
            "default", "batch-vol").write_allocs) == 0, timeout=10)
    finally:
        watchers = [t for t in server._threads
                    if t.name == "volume-watcher"]
        t0 = time.perf_counter()
        server.shutdown()
        assert time.perf_counter() - t0 < 1.0
    assert watchers and not any(t.is_alive() for t in watchers)


# -- endpoints over HTTP (the reference's) ----------------------------
def test_csi_http_routes():
    from nomad_tpu_torch.api import HTTPApiServer
    from nomad_tpu_torch.api.client import ApiClient, ApiError
    server = Server(ServerConfig(num_schedulers=0), device="cpu")
    api = HTTPApiServer(server, port=0)
    api.start()
    try:
        c = ApiClient(f"http://127.0.0.1:{api.port}")
        c._request("PUT", "/v1/volume/csi/web-vol",
                   {"Volume": {"id": "web-vol", "plugin_id": "p1"}})
        vols = c._request("GET", "/v1/volumes")
        assert [v["id"] for v in vols] == ["web-vol"]
        got = c._request("GET", "/v1/volume/csi/web-vol")
        assert got["plugin_id"] == "p1"
        c._request("DELETE", "/v1/volume/csi/web-vol")
        assert c._request("GET", "/v1/volumes") == []
    finally:
        api.shutdown()
        server.shutdown()


# -- tests/test_csi.py: the Vault token authority ----------------------
def test_vault_token_derivation_and_env():
    server = Server(ServerConfig(num_schedulers=0), device="cpu")
    try:
        alloc = mock.alloc()
        # derive validates the task carries a vault stanza
        from nomad_tpu_torch.models.job import VaultConfig
        alloc.job.task_groups[0].tasks[0].vault = \
            VaultConfig(policies=["default"])
        server.store.upsert_allocs(server.raft_apply(
            "eval_update", dict(evals=[])) or 1, [alloc])
        tokens = server.derive_vault_token(alloc.id, ["web"])
        assert tokens["web"]["token"].startswith("s.")
        assert tokens["web"]["accessor"]
        with pytest.raises(KeyError):
            server.derive_vault_token("nope", ["web"])
    finally:
        server.shutdown()
