"""The reference's plan applier suites against the port, their
assertions unchanged: tests/test_plan_applier.py (reference:
nomad/plan_apply_test.go — in-place updates reuse the alloc ID, so the
applier must drop the snapshot copy of any alloc whose ID appears in
plan.node_allocation before fit-checking, plan_apply.go:674-678) and the
group-commit cases of tests/test_plan_group.py: group apply against
one-at-a-time apply over 1,000 randomized plans, the intra-group
conflict, the queue-driven drain, the `plan_group_max=1` escape hatch,
the cross-eval engine reuse and the plan group's WAL round trip.

Left out of tests/test_plan_group.py: the env kill switch (the port reads
no environment variable) and the two governor cases (no governor).

Every server is the port's on the CPU (`device="cpu"`), shut down when
its test ends, whether it passed or not.
"""

import copy

import numpy as np
import pytest

from nomad_tpu_torch.mock import fixtures as mock
from nomad_tpu_torch.models import Plan, ALLOC_CLIENT_RUNNING
from nomad_tpu_torch.models.networks import NetworkResource, Port
from nomad_tpu_torch.server.core import Server as _Server, ServerConfig
from nomad_tpu_torch.server.plan_queue import PendingPlan
from nomad_tpu_torch.utils.ids import generate_uuid

_SERVERS = []


def Server(config=None):
    """The port's Server on the CPU, shut down after the test."""
    srv = _Server(config, device="cpu")
    _SERVERS.append(srv)
    return srv


@pytest.fixture(autouse=True)
def _shutdown_servers():
    try:
        yield
    finally:
        while _SERVERS:
            _SERVERS.pop().shutdown()


# -- tests/test_plan_applier.py --------------------------------------
def _server_applier():
    srv = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=60.0))
    return srv


def test_inplace_update_same_id_not_double_counted():
    """A plan updating an existing port-bearing alloc in place (same ID,
    same reserved port) must be accepted, not rejected as a phantom port
    collision."""
    srv = _server_applier()
    node = mock.node()
    existing = mock.alloc()
    existing.node_id = node.id
    existing.client_status = "running"
    srv.store.upsert_node(100, node)
    srv.store.upsert_allocs(101, [existing])

    updated = copy.deepcopy(existing)
    updated.job = existing.job      # in-place update: same ID, same ports

    plan = Plan(priority=50)
    plan.job = existing.job
    plan.node_allocation = {node.id: [updated]}
    plan.snapshot_index = srv.store.latest_index()

    result = srv.plan_applier.apply_sync(plan)
    full, expected, actual = result.full_commit(plan)
    assert full, (
        f"in-place update rejected: committed {actual}/{expected}; "
        f"refresh_index={result.refresh_index}")


def test_true_port_collision_still_rejected():
    """Sanity: a genuinely conflicting placement (different alloc ID,
    same reserved port) is still rejected."""
    srv = _server_applier()
    node = mock.node()
    existing = mock.alloc()
    existing.node_id = node.id
    existing.client_status = "running"
    srv.store.upsert_node(100, node)
    srv.store.upsert_allocs(101, [existing])

    clash = mock.alloc()            # fresh ID, same reserved port 5000
    clash.node_id = node.id

    plan = Plan(priority=50)
    plan.job = clash.job
    plan.node_allocation = {node.id: [clash]}
    plan.snapshot_index = srv.store.latest_index()

    result = srv.plan_applier.apply_sync(plan)
    full, _, _ = result.full_commit(plan)
    assert not full
    assert result.refresh_index > 0


# -- tests/test_plan_group.py ----------------------------------------
def _server(plan_group_max=32, **kw):
    return Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=3600.0,
                               plan_group_max=plan_group_max, **kw))


def _make_alloc(job, node_id, cpu, mem, port=None):
    a = mock.batch_alloc()
    a.id = generate_uuid()
    a.eval_id = ""
    a.job = None
    a.job_id = job.id
    a.task_group = job.task_groups[0].name
    a.node_id = node_id
    a.client_status = ALLOC_CLIENT_RUNNING
    res = a.allocated_resources.tasks["worker"]
    res.cpu.cpu_shares = int(cpu)
    res.memory.memory_mb = int(mem)
    if port is not None:
        res.networks = [NetworkResource(
            device="eth0", ip="192.168.0.100", mbits=1,
            reserved_ports=[Port(label="p", value=int(port))])]
    return a


def _gen_sequence(rng, n_nodes=10, n_plans=40):
    """One randomized plan sequence against a fixed node set. Returns
    (job, nodes, plans). Outcome-INDEPENDENT generation: stop /
    in-place targets are drawn from previously ATTEMPTED placements,
    so both arms receive byte-identical inputs and parity never
    depends on which arm accepted what."""
    job = mock.batch_job()
    nodes = [mock.node() for _ in range(n_nodes)]
    node_ids = [n.id for n in nodes]
    plans = []
    attempted = []      # (alloc_id, node_id)
    for _pi in range(n_plans):
        plan = Plan(priority=int(rng.randint(1, 100)))
        plan.job = job
        roll = rng.rand()
        if roll < 0.70 or not attempted:
            # placements: oversubscription induces conflicts, some
            # with reserved ports so collisions exercise the scalar
            # verify path too
            for _ in range(int(rng.randint(1, 4))):
                nid = node_ids[rng.randint(n_nodes)]
                port = None
                if rng.rand() < 0.25:
                    port = 7000 + int(rng.randint(3))
                a = _make_alloc(job, nid,
                                cpu=int(rng.randint(800, 2200)),
                                mem=int(rng.randint(500, 1800)),
                                port=port)
                plan.node_allocation.setdefault(nid, []).append(a)
                attempted.append((a.id, nid))
        elif roll < 0.85:
            # stop a previously attempted alloc (committed or not —
            # both arms treat an unknown id identically)
            aid, nid = attempted[rng.randint(len(attempted))]
            stop = _make_alloc(job, nid, 0, 0)
            stop.id = aid
            stop.desired_status = "stop"
            stop.allocated_resources = None
            plan.node_update.setdefault(nid, []).append(stop)
        else:
            # in-place update: same alloc id, same node, new resources
            aid, nid = attempted[rng.randint(len(attempted))]
            a = _make_alloc(job, nid,
                            cpu=int(rng.randint(400, 1500)),
                            mem=int(rng.randint(300, 1200)))
            a.id = aid
            plan.node_allocation.setdefault(nid, []).append(a)
        plans.append(plan)
    return job, nodes, plans


def _norm_result(r):
    return (
        {n: sorted(a.id for a in v)
         for n, v in r.node_allocation.items() if v},
        {n: sorted(a.id for a in v)
         for n, v in r.node_update.items() if v},
        {n: sorted(a.id for a in v)
         for n, v in r.node_preemptions.items() if v},
        bool(r.refresh_index),
    )


def _norm_store(store):
    """Final state modulo raft indexes (a group commits N plans at ONE
    index; equality is over content, not index stamps)."""
    out = {}
    for a in store.allocs():
        res = a.allocated_resources
        sig = None
        if res is not None and "worker" in res.tasks:
            tr = res.tasks["worker"]
            sig = (tr.cpu.cpu_shares, tr.memory.memory_mb)
        out[a.id] = (a.node_id, a.desired_status, a.client_status,
                     a.job_id, sig)
    return out


def _apply_sequential(job, nodes, plans):
    srv = _server(plan_group_max=1)
    idx = 100
    for n in nodes:
        srv.store.upsert_node(idx, n)
        idx += 1
    srv._raft_index = idx
    srv.store.upsert_job(idx, job)
    results = [srv.plan_applier.apply_sync(p) for p in plans]
    return srv, results


def _apply_grouped(job, nodes, plans, rng):
    srv = _server(plan_group_max=32)
    idx = 100
    for n in nodes:
        srv.store.upsert_node(idx, n)
        idx += 1
    srv._raft_index = idx
    srv.store.upsert_job(idx, job)
    results = []
    i = 0
    while i < len(plans):
        size = int(rng.randint(1, 7))
        chunk = [PendingPlan(p) for p in plans[i:i + size]]
        i += size
        pairs, waiter, _gidx = srv.plan_applier.apply_group(chunk)
        assert waiter is None           # dev mode applies inline
        assert len(pairs) == len(chunk)
        results.extend(r for _f, r in pairs)
    return srv, results


def test_randomized_group_vs_sequential_parity():
    """>= 1k shuffled plans: group-apply == one-at-a-time, final store
    state AND per-plan results, conflicts included."""
    n_seqs, n_plans = 25, 40            # 1000 plans total
    total_partial = 0
    for seq in range(n_seqs):
        rng = np.random.RandomState(4000 + seq)
        job, nodes, plans = _gen_sequence(rng, n_plans=n_plans)
        job_a, nodes_a, plans_a = copy.deepcopy((job, nodes, plans))
        job_b, nodes_b, plans_b = copy.deepcopy((job, nodes, plans))
        srv_a, res_a = _apply_sequential(job_a, nodes_a, plans_a)
        srv_b, res_b = _apply_grouped(job_b, nodes_b, plans_b,
                                      np.random.RandomState(9000 + seq))
        for k, (ra, rb) in enumerate(zip(res_a, res_b)):
            assert _norm_result(ra) == _norm_result(rb), \
                f"seq {seq} plan {k}: results diverged"
        assert _norm_store(srv_a.store) == _norm_store(srv_b.store), \
            f"seq {seq}: final store state diverged"
        total_partial += sum(1 for r in res_a if r.refresh_index)
    # the suite must actually exercise conflict demotion, not just
    # happy-path commits
    assert total_partial > 50, \
        f"only {total_partial} partial results — conflicts not induced"


def test_intra_group_conflict_demotes_like_sequential():
    """Two plans filling the same node: in one group the second must
    demote to the same partial result sequential apply produces."""
    job = mock.batch_job()
    node = mock.node()
    p1 = Plan(priority=50)
    p1.job = job
    a1 = _make_alloc(job, node.id, 3000, 6000)
    p1.node_allocation = {node.id: [a1]}
    p2 = Plan(priority=50)
    p2.job = job
    a2 = _make_alloc(job, node.id, 3000, 6000)
    p2.node_allocation = {node.id: [a2]}

    # sequential
    (job_a, node_a, p1a, p2a) = copy.deepcopy((job, node, p1, p2))
    srv_a = _server()
    srv_a.store.upsert_node(100, node_a)
    srv_a.store.upsert_job(101, job_a)
    srv_a._raft_index = 101
    r1a = srv_a.plan_applier.apply_sync(p1a)
    r2a = srv_a.plan_applier.apply_sync(p2a)
    assert r1a.node_allocation and not r1a.refresh_index
    assert not r2a.node_allocation and r2a.refresh_index

    # grouped
    (job_b, node_b, p1b, p2b) = copy.deepcopy((job, node, p1, p2))
    srv_b = _server()
    srv_b.store.upsert_node(100, node_b)
    srv_b.store.upsert_job(101, job_b)
    srv_b._raft_index = 101
    pairs, waiter, gidx = srv_b.plan_applier.apply_group(
        [PendingPlan(p1b), PendingPlan(p2b)])
    assert waiter is None
    (_f1, r1b), (_f2, r2b) = pairs
    assert _norm_result(r1a) == _norm_result(r1b)
    assert _norm_result(r2a) == _norm_result(r2b)
    # the demoted plan's refresh fence points at the group's commit
    # index so the retry sees the winner's claim
    assert r2b.refresh_index >= gidx > 0
    assert srv_b.plan_applier.stats["conflict_retries"] == 1
    assert _norm_store(srv_a.store) == _norm_store(srv_b.store)


def _queue_driven(srv, plans, timeout=10.0):
    """Enqueue plans BEFORE starting the applier so the first drain
    forms one deterministic group; returns per-plan results."""
    srv.plan_queue.set_enabled(True)
    futures = [srv.plan_queue.enqueue(p) for p in plans]
    srv.plan_applier.start()
    try:
        return [f.result(timeout=timeout) for f in futures]
    finally:
        srv.plan_applier.stop()


def _spy_raft(srv, types):
    orig = srv.raft_apply_async

    def spy(msg_type, payload):
        types.append(msg_type)
        return orig(msg_type, payload)

    srv.raft_apply_async = spy


def _simple_plans(job, nodes, k):
    plans = []
    for i in range(k):
        p = Plan(priority=50)
        p.job = job
        nid = nodes[i % len(nodes)].id
        p.node_allocation = {nid: [_make_alloc(job, nid, 500, 400)]}
        plans.append(p)
    return plans


def test_queue_drain_commits_one_group_entry():
    srv = _server(plan_group_max=8)
    job = mock.batch_job()
    nodes = [mock.node() for _ in range(4)]
    for i, n in enumerate(nodes):
        srv.store.upsert_node(100 + i, n)
    srv._raft_index = 110
    srv.store.upsert_job(110, job)
    types = []
    _spy_raft(srv, types)
    results = _queue_driven(srv, _simple_plans(job, nodes, 4))
    assert types.count("plan_group_results") == 1
    assert "plan_results" not in types
    assert all(r.node_allocation and not r.refresh_index
               for r in results)
    assert srv.plan_applier.stats["groups"] == 1
    assert srv.plan_applier.stats["plans"] == 4
    assert srv.plan_applier.mean_group_size() == 4.0
    # all four placements landed in the store in ONE transaction
    assert len(srv.store.allocs()) == 4


def test_plan_group_max_1_escape_hatch():
    """plan_group_max=1 must reproduce the one-entry-per-plan path."""
    srv = _server(plan_group_max=1)
    job = mock.batch_job()
    nodes = [mock.node() for _ in range(4)]
    for i, n in enumerate(nodes):
        srv.store.upsert_node(100 + i, n)
    srv._raft_index = 110
    srv.store.upsert_job(110, job)
    types = []
    _spy_raft(srv, types)
    results = _queue_driven(srv, _simple_plans(job, nodes, 4))
    assert types.count("plan_results") == 4
    assert "plan_group_results" not in types
    assert all(r.node_allocation for r in results)
    assert srv.plan_applier.stats["singleton_fallbacks"] == 4


def test_engine_state_reuse_across_evals():
    """Cross-eval host-phase reuse: a second engine (= a second eval)
    for the same job version skips the static-key walk AND the
    combined mask build — and the reuse survives alloc-delta table
    refreshes (mask_cache is shared across delta clones), while a
    re-registered job version recomputes."""
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.scheduler.stack import (ENGINE_CACHE_STATS,
                                           PlacementEngine,
                                           clear_engine_cache)

    clear_engine_cache()
    h = Harness(device="cpu")
    for i in range(12):
        n = mock.node()
        n.name = f"node-{i}"
        h.store.upsert_node(h.next_index(), n)
    job = mock.batch_job()
    h.store.upsert_job(h.next_index(), job)
    stored = h.store.job_by_id(job.namespace, job.id)
    tg = stored.task_groups[0]

    def run_engine():
        snap = h.store.snapshot()
        e = PlacementEngine(snap, device="cpu")
        e.set_job(h.store.job_by_id(job.namespace, job.id))
        e.set_nodes(stored.datacenters)
        mask, counts = e.feasibility(tg)
        assert mask.any()
        return mask

    before = dict(ENGINE_CACHE_STATS)
    m1 = run_engine()
    mid = dict(ENGINE_CACHE_STATS)
    assert mid["entry_misses"] == before["entry_misses"] + 1
    assert mid["mask_misses"] == before["mask_misses"] + 1

    # an alloc-delta table refresh between evals must NOT invalidate
    # the static state (attribute/ready columns are shared)
    a = _make_alloc(stored, h.store.nodes()[0].id, 500, 400)
    a.job = stored
    h.store.upsert_plan_results(
        h.next_index(), allocs_stopped=[], allocs_placed=[a],
        allocs_preempted=[])
    m2 = run_engine()
    after = dict(ENGINE_CACHE_STATS)
    assert after["entry_hits"] == mid["entry_hits"] + 1
    assert after["mask_hits"] == mid["mask_hits"] + 1
    assert after["mask_misses"] == mid["mask_misses"]
    assert (m1 == m2).all()

    # version bump (spec change) recomputes instead of serving stale
    bumped = copy.deepcopy(stored)
    bumped.version = stored.version + 1
    h.store.upsert_job(h.next_index(), bumped)
    snap = h.store.snapshot()
    e = PlacementEngine(snap, device="cpu")
    e.set_job(h.store.job_by_id(job.namespace, job.id))
    e.set_nodes(stored.datacenters)
    e.feasibility(e.job.task_groups[0])
    final = dict(ENGINE_CACHE_STATS)
    assert final["entry_misses"] > after["entry_misses"]


def test_group_entry_survives_wal_roundtrip():
    """The plan_group_results payload must encode/decode through the
    WAL schema (clustered replication + replay share it)."""
    from nomad_tpu_torch.server.persistence import (decode_payload,
                                                    encode_payload)
    job = mock.batch_job()
    a = _make_alloc(job, "n1", 500, 400)
    payload = dict(groups=[dict(allocs_stopped=[], allocs_placed=[a],
                                allocs_preempted=[], deployment=None,
                                deployment_updates=[], evals=[])])
    enc = encode_payload("plan_group_results", payload)
    dec = decode_payload("plan_group_results", enc)
    assert len(dec["groups"]) == 1
    back = dec["groups"][0]["allocs_placed"][0]
    assert back.id == a.id
    assert back.node_id == "n1"
