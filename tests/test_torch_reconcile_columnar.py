"""The reference's columnar reconcile tests (tests/test_reconcile_columnar.py)
against the port, their assertions unchanged, on the CPU.

The columnar engine (scheduler/reconcile_columnar.py over
state/alloc_index.py) must be OBSERVATIONALLY IDENTICAL to the
reference AllocReconciler: same per-tg desired counts, same stop /
place / destructive / in-place sets, same follow-up eval batching, and
the same deployment lifecycle — across randomized combinations of job
versions, tainted nodes, canaries, deployments, batch vs service, and
stopped jobs: >= 1k shuffled scenarios, both engines the port's copies.

The port has no NOMAD_TPU_COLUMNAR_RECONCILE: test_escape_hatch_equivalence
runs the port's columnar path through the full GenericScheduler against
the JAX package's reference path (the switch set on the JAX side only and
restored after). test_reconcile_governor_gauges waits for the governor.
"""

import os
import random

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import (
    ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED, ALLOC_CLIENT_LOST,
    ALLOC_CLIENT_PENDING, ALLOC_CLIENT_RUNNING,
    ALLOC_DESIRED_EVICT, ALLOC_DESIRED_RUN, ALLOC_DESIRED_STOP,
    NODE_STATUS_DOWN, NODE_STATUS_READY,
    UpdateStrategy,
)
from nomad_tpu_torch.models.alloc import (AllocDeploymentStatus,
                                    DesiredTransition, RescheduleEvent,
                                    RescheduleTracker, TaskState,
                                    TASK_STATE_DEAD, TASK_STATE_RUNNING)
from nomad_tpu_torch.models.deployment import (
    Deployment, DeploymentState,
    DEPLOYMENT_STATUS_FAILED, DEPLOYMENT_STATUS_PAUSED,
    DEPLOYMENT_STATUS_RUNNING, DEPLOYMENT_STATUS_SUCCESSFUL,
)
from nomad_tpu_torch.models.evaluation import Evaluation
from nomad_tpu_torch.scheduler.harness import Harness
from nomad_tpu_torch.scheduler.reconcile import AllocReconciler
from nomad_tpu_torch.scheduler.reconcile_columnar import ColumnarAllocReconciler
from nomad_tpu_torch.scheduler.util import tasks_updated
from nomad_tpu_torch.state.alloc_index import JobAllocColumns
from nomad_tpu_torch.utils.ids import generate_uuid

import test_torch_select  # noqa: F401  (torch's thread cap)

NOW = 1_700_000_000.0

CLIENT_STATUSES = (ALLOC_CLIENT_PENDING, ALLOC_CLIENT_RUNNING,
                   ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED,
                   ALLOC_CLIENT_LOST)
DESIRED_STATUSES = (ALLOC_DESIRED_RUN, ALLOC_DESIRED_RUN,
                    ALLOC_DESIRED_RUN, ALLOC_DESIRED_STOP,
                    ALLOC_DESIRED_EVICT)


def generic_update_fn(alloc, job, tg):
    """The generic scheduler's decision ladder minus the store-backed
    single-node feasibility tail (parity runs pure): in-place
    candidates report in-place with the existing alloc as the update."""
    if alloc.job is not None and \
            alloc.job.job_modify_index == job.job_modify_index:
        return True, False, None
    if alloc.job is None:
        return False, True, None
    if tasks_updated(job, alloc.job, tg.name):
        return False, True, None
    if alloc.terminal_status():
        return True, False, None
    return False, False, alloc


def _ignore_fn(alloc, job, tg):
    return True, False, None


def _destructive_fn(alloc, job, tg):
    return False, True, None


def _inplace_fn(alloc, job, tg):
    return False, False, alloc


def make_scenario(rng: random.Random):
    batch = rng.random() < 0.35
    job0 = mock.batch_job() if batch else mock.job()
    tg0 = job0.task_groups[0]
    job0.version = 0
    job0.create_index = 100
    job0.modify_index = 100
    job0.job_modify_index = 100
    tg0.count = rng.randint(0, 8)
    roll = rng.random()
    if roll < 0.35:
        tg0.update = UpdateStrategy(
            max_parallel=rng.randint(0, 3),
            canary=rng.choice((0, 0, 1, 2)),
            auto_revert=rng.random() < 0.3,
            auto_promote=rng.random() < 0.3)
    else:
        tg0.update = None

    # a second version with (maybe) a real spec change
    job1 = job0.copy()
    job1.version = 1
    job1.modify_index = 200
    job1.job_modify_index = 200
    if rng.random() < 0.7:
        job1.task_groups[0].tasks[0].env = {"WAVE": "1"}

    new_job = job1 if rng.random() < 0.6 else job0
    if rng.random() < 0.1:
        new_job = new_job.copy()
        new_job.stop = True
    job_versions = [job0, job1, None]

    # node pool with tainted members
    nodes = {}
    tainted = {}
    for i in range(6):
        nid = f"node-{i}"
        node = mock.node()
        node.id = nid
        kind = rng.random()
        if kind < 0.15:
            tainted[nid] = None          # GC'd
        elif kind < 0.3:
            node.status = NODE_STATUS_DOWN
            tainted[nid] = node
        elif kind < 0.45:
            node.drain = True
            tainted[nid] = node          # draining, not lost
        nodes[nid] = node

    tg_names = [tg0.name]
    if rng.random() < 0.2:
        tg_names.append("ghost")         # group the job no longer has

    allocs = []
    canary_pool = []
    for i in range(rng.randint(0, 30)):
        a = mock.alloc() if not batch else mock.batch_alloc()
        a.id = generate_uuid()
        a.job = rng.choice(job_versions)
        a.job_id = new_job.id
        a.namespace = "default"
        tg_name = rng.choice(tg_names)
        a.task_group = tg_name
        if rng.random() < 0.9:
            a.name = f"{new_job.id}.{tg_name}[{rng.randint(0, 10)}]"
        else:
            a.name = "malformed"
        a.node_id = f"node-{rng.randint(0, 5)}"
        a.client_status = rng.choice(CLIENT_STATUSES)
        a.desired_status = rng.choice(DESIRED_STATUSES)
        a.desired_transition = DesiredTransition(
            migrate=rng.random() < 0.1 or None,
            reschedule=rng.random() < 0.1 or None,
            force_reschedule=rng.random() < 0.05 or None)
        if rng.random() < 0.15:
            a.next_allocation = generate_uuid()
        if rng.random() < 0.15:
            a.follow_up_eval_id = rng.choice(("eval-1", generate_uuid()))
        if rng.random() < 0.3:
            a.deployment_status = AllocDeploymentStatus(
                healthy=rng.choice((None, True, False)),
                canary=rng.random() < 0.4)
        if a.client_status == ALLOC_CLIENT_FAILED and rng.random() < 0.7:
            # a failure time so reschedule eligibility can fire
            a.task_states = {"web": TaskState(
                state=TASK_STATE_DEAD, failed=True,
                finished_at=NOW - rng.choice((1.0, 30.0, 1200.0)))}
            if rng.random() < 0.4:
                a.reschedule_tracker = RescheduleTracker(events=[
                    RescheduleEvent(reschedule_time=NOW - 100.0,
                                    prev_alloc_id=generate_uuid(),
                                    prev_node_id="node-0")])
        elif batch and a.desired_status in (ALLOC_DESIRED_STOP,
                                            ALLOC_DESIRED_EVICT) \
                and rng.random() < 0.5:
            a.task_states = {"worker": TaskState(
                state=TASK_STATE_DEAD, failed=False,
                finished_at=NOW - 5.0)}
        allocs.append(a)
        canary_pool.append(a.id)

    deployment = None
    if rng.random() < 0.45 and canary_pool:
        match = rng.random() < 0.7
        deployment = Deployment(
            namespace="default", job_id=new_job.id,
            job_version=new_job.version if match else 7,
            job_create_index=new_job.create_index,
            status=rng.choice((DEPLOYMENT_STATUS_RUNNING,
                               DEPLOYMENT_STATUS_RUNNING,
                               DEPLOYMENT_STATUS_PAUSED,
                               DEPLOYMENT_STATUS_FAILED,
                               DEPLOYMENT_STATUS_SUCCESSFUL)))
        ds = DeploymentState(
            promoted=rng.random() < 0.4,
            desired_canaries=rng.choice((0, 0, 1, 2)),
            placed_canaries=rng.sample(
                canary_pool, min(len(canary_pool), rng.randint(0, 3))))
        deployment.task_groups[tg0.name] = ds
        # deployment membership on some allocs
        for a in allocs:
            if rng.random() < 0.3:
                a.deployment_id = deployment.id

    job_arg = None if rng.random() < 0.05 else new_job
    return dict(batch=batch, job=job_arg, job_id=new_job.id,
                allocs=allocs, tainted=tainted, deployment=deployment,
                new_job=new_job)


# -- canonicalization --------------------------------------------------

def _followup_partition(res):
    """Follow-up eval ids are fresh uuids per run; compare the
    PARTITION they induce plus each eval's wait_until."""
    groups = {}
    for s in res.stop:
        if s.followup_eval_id:
            groups.setdefault(s.followup_eval_id, set()).add(
                ("stop", s.alloc.id))
    for aid, alloc in res.attribute_updates.items():
        if alloc.follow_up_eval_id:
            groups.setdefault(alloc.follow_up_eval_id, set()).add(
                ("attr", aid))
    evs = {}
    for tg, lst in res.desired_followup_evals.items():
        for ev in lst:
            evs[ev.id] = (tg, round(ev.wait_until, 6))
    out = []
    for eid, members in groups.items():
        out.append((evs.get(eid), tuple(sorted(members))))
    # evals may exist with no mapped members (batched window edge)
    mapped = set(groups)
    out.extend((evs[eid], ()) for eid in evs if eid not in mapped)
    return sorted(out, key=repr)


def canon(res):
    import dataclasses as dc
    dstate = None
    if res.deployment is not None:
        dstate = sorted(
            (name, s.desired_total, s.desired_canaries, s.auto_revert,
             s.auto_promote, s.promoted, s.progress_deadline_s)
            for name, s in res.deployment.task_groups.items())
    return {
        "desired": {tg: dc.astuple(du)
                    for tg, du in res.desired_tg_updates.items()},
        "stop": sorted((s.alloc.id, s.client_status,
                        s.status_description,
                        bool(s.followup_eval_id)) for s in res.stop),
        "place": sorted((p.name, bool(p.canary),
                         p.task_group.name if p.task_group else None,
                         p.previous_alloc.id if p.previous_alloc else "",
                         bool(p.reschedule),
                         bool(p.downgrade_non_canary),
                         p.min_job_version) for p in res.place),
        "destructive": sorted((d.place_name, d.stop_alloc.id)
                              for d in res.destructive_update),
        "inplace": sorted(a.id for a in res.inplace_update),
        "attr_updates": sorted(res.attribute_updates.keys()),
        "dep_updates": sorted((u.status, u.status_description)
                              for u in res.deployment_updates),
        "deployment": dstate,
        "followups": _followup_partition(res),
    }


def run_pair(sc, update_fn=None, spec_fn=True):
    fn = update_fn or generic_update_fn
    ref = AllocReconciler(fn, sc["batch"], sc["job_id"], sc["job"],
                          sc["deployment"], list(sc["allocs"]),
                          dict(sc["tainted"]), "eval-1", now=NOW)
    cols = JobAllocColumns.build(list(sc["allocs"]))
    spec_change = None
    if spec_fn and sc["job"] is not None and fn is generic_update_fn:
        spec_change = lambda old, tgn: tasks_updated(sc["job"], old, tgn)
    col = ColumnarAllocReconciler(fn, sc["batch"], sc["job_id"],
                                  sc["job"], sc["deployment"], cols,
                                  dict(sc["tainted"]), "eval-1",
                                  now=NOW, spec_change_fn=spec_change)
    return canon(ref.compute()), canon(col.compute())


def test_randomized_parity_1k():
    """Acceptance: >= 1k shuffled scenarios, columnar == reference."""
    for seed in range(1000):
        rng = random.Random(seed)
        sc = make_scenario(rng)
        a, b = run_pair(sc)
        assert a == b, f"parity break at seed {seed}:\n{a}\nvs\n{b}"


def test_randomized_parity_custom_update_fns():
    """Without a spec_change_fn the columnar engine must still honor
    arbitrary alloc_update_fns via the reference per-alloc loop."""
    fns = (_ignore_fn, _destructive_fn, _inplace_fn)
    for seed in range(200):
        rng = random.Random(10_000 + seed)
        sc = make_scenario(rng)
        fn = fns[seed % len(fns)]
        a, b = run_pair(sc, update_fn=fn, spec_fn=False)
        assert a == b, f"custom-fn parity break at seed {seed}"


def test_parity_shuffled_alloc_order():
    """Row order must not change outcomes: same scenario, shuffled
    alloc list for the columnar index."""
    for seed in range(60):
        rng = random.Random(20_000 + seed)
        sc = make_scenario(rng)
        ref = AllocReconciler(generic_update_fn, sc["batch"],
                              sc["job_id"], sc["job"], sc["deployment"],
                              list(sc["allocs"]), dict(sc["tainted"]),
                              "eval-1", now=NOW)
        shuffled = list(sc["allocs"])
        rng.shuffle(shuffled)
        cols = JobAllocColumns.build(shuffled)
        col = ColumnarAllocReconciler(
            generic_update_fn, sc["batch"], sc["job_id"], sc["job"],
            sc["deployment"], cols, dict(sc["tainted"]), "eval-1",
            now=NOW,
            spec_change_fn=(None if sc["job"] is None else
                            (lambda old, tgn, j=sc["job"]:
                             tasks_updated(j, old, tgn))))
        assert canon(ref.compute()) == canon(col.compute()), \
            f"order-dependence at seed {seed}"


# -- incremental index == dense rebuild --------------------------------

def test_index_incremental_matches_dense():
    """Drive a real StateStore through upserts / client updates /
    desired transitions / deletes; the write-through columnar index
    must equal a dense rebuild from the same snapshot after every
    batch of mutations."""
    from nomad_tpu_torch.state import StateStore

    rng = random.Random(7)
    store = StateStore()
    job = mock.job()
    idx = 100
    store.upsert_job(idx, job)

    def column_view(cols):
        out = {}
        for r in range(cols.n):
            out[cols.ids[r]] = (
                int(cols.client[r]), int(cols.desired[r]),
                cols.tg_names[cols.tg_code[r]], int(cols.name_idx[r]),
                cols.node_ids[cols.node_code[r]],
                bool(cols.has_job[r]), int(cols.job_version[r]),
                int(cols.job_mod[r]), bool(cols.migrate[r]),
                bool(cols.force_resched[r]), bool(cols.resched_flag[r]),
                int(cols.healthy[r]),
                cols.dep_ids[cols.dep_code[r]]
                if cols.dep_code[r] >= 0 else "",
                bool(cols.has_next[r]),
                cols.allocs[r].id)
        return out

    live = []
    for round_ in range(12):
        idx += 1
        op = rng.random()
        if op < 0.5 or not live:
            batch = []
            for _ in range(rng.randint(1, 6)):
                a = mock.alloc()
                a.job = job
                a.job_id = job.id
                a.name = f"{job.id}.web[{rng.randint(0, 20)}]"
                a.node_id = f"n-{rng.randint(0, 4)}"
                a.client_status = rng.choice(CLIENT_STATUSES)
                batch.append(a)
                live.append(a.id)
            store.upsert_allocs(idx, batch)
        elif op < 0.8:
            aid = rng.choice(live)
            a = store.alloc_by_id(aid).copy()
            a.client_status = rng.choice(CLIENT_STATUSES)
            store.update_allocs_from_client(idx, [a])
        else:
            aid = rng.choice(live)
            live.remove(aid)
            store.delete_evals(idx, [], alloc_ids=[aid])

        snap = store.snapshot()
        cols = snap.job_alloc_columns(job.namespace, job.id)
        assert cols is not None
        dense = JobAllocColumns.build(
            snap.allocs_by_job(job.namespace, job.id))
        assert column_view(cols) == column_view(dense), \
            f"index drift after round {round_}"
    # the index must have been maintained incrementally, not rebuilt
    # per read
    assert store.alloc_index.stats["rebuilds"] == 1
    assert store.alloc_index.stats["delta_syncs"] >= 10


# -- escape hatch through the full scheduler ---------------------------

def _drive_sched(pkg):
    """The scenario through one package's full GenericScheduler: the
    port's columnar path, or the JAX package's under its switch."""
    mock, Harness, Evaluation, generate_uuid, NODE_STATUS_DOWN = pkg
    h = Harness()
    nodes = [mock.node() for _ in range(6)]
    for n in nodes:
        h.store.upsert_node(h.next_index(), n)
    job = mock.job()
    job.task_groups[0].count = 8
    h.store.upsert_job(h.next_index(), job)

    def ev():
        return Evaluation(
            id=generate_uuid(), namespace=job.namespace,
            priority=job.priority, type=job.type,
            triggered_by="job-register", job_id=job.id,
            status="pending")

    h.process("service", ev())              # initial placement
    h.process("service", ev())              # steady-state no-op
    job = job.copy()
    job.task_groups[0].tasks[0].env = {"V": "2"}   # destructive
    h.store.upsert_job(h.next_index(), job)
    h.process("service", ev())
    job = job.copy()
    job.task_groups[0].count = 5            # scale down
    h.store.upsert_job(h.next_index(), job)
    h.process("service", ev())
    # drain a node that hosts something
    hosting = {a.node_id for a in
               h.store.allocs_by_job(job.namespace, job.id)
               if not a.terminal_status()}
    if hosting:
        nid = sorted(hosting)[0]
        h.store.update_node_status(h.next_index(), nid,
                                   NODE_STATUS_DOWN)
        h.process("service", ev())

    allocs = h.store.allocs_by_job(job.namespace, job.id)
    state = sorted((a.name.replace(job.id, "JOB"), a.task_group,
                    a.desired_status, a.client_status)
                   for a in allocs)
    queued = dict(h.evals[-1].queued_allocations or {})
    statuses = [e.status for e in h.evals]
    return state, queued, statuses


def test_escape_hatch_equivalence():
    """The JAX package's NOMAD_TPU_COLUMNAR_RECONCILE=0 (reference path)
    and the port's columnar path must produce the same final store
    shape, per-tg queued counts, and eval statuses through the full
    scheduler."""
    from nomad_tpu import mock as jmock
    from nomad_tpu.models import NODE_STATUS_DOWN as J_NODE_STATUS_DOWN
    from nomad_tpu.models.evaluation import Evaluation as JEvaluation
    from nomad_tpu.scheduler.harness import Harness as JHarness
    from nomad_tpu.utils.ids import generate_uuid as jgenerate_uuid
    on = _drive_sched((mock, lambda: Harness(device="cpu"), Evaluation,
                       generate_uuid, NODE_STATUS_DOWN))
    prev = os.environ.get("NOMAD_TPU_COLUMNAR_RECONCILE")
    os.environ["NOMAD_TPU_COLUMNAR_RECONCILE"] = "0"
    try:
        off = _drive_sched((jmock, JHarness, JEvaluation, jgenerate_uuid,
                            J_NODE_STATUS_DOWN))
    finally:
        if prev is None:
            os.environ.pop("NOMAD_TPU_COLUMNAR_RECONCILE", None)
        else:
            os.environ["NOMAD_TPU_COLUMNAR_RECONCILE"] = prev
    assert on == off


# -- index fold / stage surfaces ---------------------------------------

def test_reconcile_index_fold_reclaim():
    from nomad_tpu_torch.state import StateStore
    st = StateStore()
    job = mock.job()
    st.upsert_job(100, job)
    batch = []
    for i in range(5):
        a = mock.alloc()
        a.job = job
        a.job_id = job.id
        batch.append(a)
    st.upsert_allocs(101, batch)
    assert st.snapshot().job_alloc_columns("default", job.id) is not None
    assert st.alloc_index.rows() == 5
    more = mock.alloc()
    more.job = job
    more.job_id = job.id
    st.upsert_allocs(102, [more])
    assert st.alloc_index.debt() == 1
    out = st.alloc_index.fold()
    assert out["entries_dropped"] == 1
    assert st.alloc_index.debt() == 0
    # next read rebuilds dense and still agrees
    cols = st.snapshot().job_alloc_columns("default", job.id)
    assert cols.n == 6
    assert st.alloc_index.stats["rebuilds"] == 2


def test_reconcile_stage_reported():
    from nomad_tpu_torch.utils import stages
    stages.enable()
    try:
        h = Harness(device="cpu")
        for _ in range(4):
            h.store.upsert_node(h.next_index(), mock.node())
        job = mock.job()
        job.task_groups[0].count = 3
        h.store.upsert_job(h.next_index(), job)
        h.process("service", Evaluation(
            id=generate_uuid(), namespace=job.namespace,
            priority=job.priority, type=job.type,
            triggered_by="job-register", job_id=job.id,
            status="pending"))
        snap = stages.snapshot()
        assert snap["reconcile"]["calls"] >= 1
        assert snap["reconcile"]["seconds"] >= 0.0
    finally:
        stages.disable()


def test_columnar_disabled_via_config():
    from nomad_tpu_torch.state import StateStore
    st = StateStore()
    st.alloc_index.enabled = False
    job = mock.job()
    st.upsert_job(100, job)
    a = mock.alloc()
    a.job = job
    a.job_id = job.id
    st.upsert_allocs(101, [a])
    assert st.snapshot().job_alloc_columns("default", job.id) is None
