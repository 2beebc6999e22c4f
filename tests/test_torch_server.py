"""The reference's control plane tests (tests/test_server.py: broker,
blocked evals, plan queue; reference patterns nomad/eval_broker_test.go,
blocked_evals_test.go, plan_apply_test.go) against the port's server,
their assertions unchanged; and the plan endpoint of
tests/test_annotate_golden.py, which reaches the port's
scheduler/annotate.py through Server.plan_job on the CPU."""

import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import Evaluation, Plan, EVAL_STATUS_BLOCKED
from nomad_tpu_torch.server import EvalBroker, BlockedEvals, PlanQueue
from nomad_tpu_torch.server.eval_broker import FAILED_QUEUE


def _eval(job_id="job1", prio=50, typ="service", **kw):
    return Evaluation(job_id=job_id, priority=prio, type=typ, **kw)


@pytest.fixture
def make_broker():
    """EvalBroker(...) for one test, disabled at its teardown: an eval
    left unacked would otherwise fire its nack timer 60 s later and
    start new timer threads under whatever test runs then."""
    made = []

    def make(**kw):
        b = EvalBroker(**kw)
        made.append(b)
        return b
    yield make
    for b in made:
        b.set_enabled(False)


class TestEvalBroker:
    def test_enqueue_dequeue_ack(self, make_broker):
        b = make_broker()
        b.set_enabled(True)
        ev = _eval()
        b.enqueue(ev)
        got, token = b.dequeue(["service"], timeout_s=1)
        assert got.id == ev.id
        assert token
        assert b.outstanding(ev.id) == token
        b.ack(ev.id, token)
        assert b.outstanding(ev.id) is None
        assert b.stats.total_ready == 0

    def test_priority_order(self, make_broker):
        b = make_broker()
        b.set_enabled(True)
        low = _eval(job_id="a", prio=10)
        high = _eval(job_id="b", prio=90)
        b.enqueue(low)
        b.enqueue(high)
        got, t1 = b.dequeue(["service"], timeout_s=1)
        assert got.id == high.id

    def test_one_outstanding_per_job(self, make_broker):
        b = make_broker()
        b.set_enabled(True)
        e1, e2 = _eval(job_id="j"), _eval(job_id="j")
        b.enqueue(e1)
        b.enqueue(e2)
        got, token = b.dequeue(["service"], timeout_s=1)
        assert got.id == e1.id
        # second eval for the job is held back
        none, _ = b.dequeue(["service"], timeout_s=0.05)
        assert none is None
        assert b.stats.total_blocked == 1
        b.ack(e1.id, token)
        got2, t2 = b.dequeue(["service"], timeout_s=1)
        assert got2.id == e2.id

    def test_nack_requeues_with_delay_then_failed_queue(self, make_broker):
        b = make_broker(delivery_limit=2, initial_nack_delay_s=0.01,
                        subsequent_nack_delay_s=0.01)
        b.set_enabled(True)
        ev = _eval()
        b.enqueue(ev)
        got, token = b.dequeue(["service"], timeout_s=1)
        b.nack(ev.id, token)
        got, token = b.dequeue(["service"], timeout_s=1)   # waits the delay
        assert got.id == ev.id
        b.nack(ev.id, token)
        # delivery limit hit -> failed queue
        got, token = b.dequeue([FAILED_QUEUE], timeout_s=1)
        assert got.id == ev.id

    def test_wait_until_delayed(self, make_broker):
        b = make_broker()
        b.set_enabled(True)
        ev = _eval()
        ev.wait_until = time.time() + 0.15
        b.enqueue(ev)
        none, _ = b.dequeue(["service"], timeout_s=0.05)
        assert none is None
        got, _ = b.dequeue(["service"], timeout_s=1.0)
        assert got.id == ev.id

    def test_register_admission_escalation(self, make_broker):
        """check_register_admission: silent below the delayed-heap
        watermark (and when disabled), AdmissionOverloadError with a
        depth-scaled Retry-After at/over it."""
        from nomad_tpu_torch.server.eval_broker import AdmissionOverloadError

        b = make_broker()
        b.set_enabled(True)
        b.check_register_admission()        # high=0: disabled, no-op
        b.delayed_depth_high = 3
        far = time.time() + 300
        for i in range(2):
            ev = _eval(job_id=f"bp{i}")
            ev.wait_until = far
            b.enqueue(ev)
        assert b.delayed_depth() == 2
        b.check_register_admission()        # below watermark: admits
        ev = _eval(job_id="bp2")
        ev.wait_until = far
        b.enqueue(ev)
        with pytest.raises(AdmissionOverloadError) as e:
            b.check_register_admission()
        assert e.value.retry_after_s >= 1.0
        # deeper backlog -> longer Retry-After (monotone escalation)
        for i in range(3, 9):
            ev = _eval(job_id=f"bp{i}")
            ev.wait_until = far
            b.enqueue(ev)
        with pytest.raises(AdmissionOverloadError) as e2:
            b.check_register_admission()
        assert e2.value.retry_after_s >= e.value.retry_after_s
        b.flush()

    def test_scheduler_type_routing(self, make_broker):
        b = make_broker()
        b.set_enabled(True)
        b.enqueue(_eval(job_id="a", typ="batch"))
        none, _ = b.dequeue(["service"], timeout_s=0.05)
        assert none is None
        got, _ = b.dequeue(["batch"], timeout_s=1)
        assert got is not None


class TestBlockedEvals:
    def test_block_unblock_by_class(self):
        woken = []
        be = BlockedEvals(lambda ev: woken.append(ev))
        be.set_enabled(True)
        ev = _eval(status=EVAL_STATUS_BLOCKED)
        ev.class_eligibility = {"v1:abc": False, "v1:def": True}
        be.block(ev)
        assert be.blocked_count() == 1
        be.unblock("v1:abc", 100)     # ineligible class: stays blocked
        assert be.blocked_count() == 1
        be.unblock("v1:def", 101)     # eligible class: wake
        assert be.blocked_count() == 0
        assert woken[0].id == ev.id

    def test_unknown_class_wakes(self):
        woken = []
        be = BlockedEvals(lambda ev: woken.append(ev))
        be.set_enabled(True)
        ev = _eval(status=EVAL_STATUS_BLOCKED)
        be.block(ev)
        be.unblock("v1:unseen", 100)
        assert woken

    def test_escaped_always_woken(self):
        woken = []
        be = BlockedEvals(lambda ev: woken.append(ev))
        be.set_enabled(True)
        ev = _eval(status=EVAL_STATUS_BLOCKED)
        ev.escaped_computed_class = True
        ev.class_eligibility = {"v1:abc": False}
        be.block(ev)
        be.unblock("v1:abc", 100)
        assert woken

    def test_job_dedup(self):
        be = BlockedEvals(lambda ev: None)
        be.set_enabled(True)
        e1 = _eval(job_id="j", status=EVAL_STATUS_BLOCKED)
        e2 = _eval(job_id="j", status=EVAL_STATUS_BLOCKED)
        be.block(e1)
        be.block(e2)
        assert be.blocked_count() == 1
        assert [d.id for d in be.get_duplicates()] == [e1.id]

    def test_missed_unblock(self):
        woken = []
        be = BlockedEvals(lambda ev: woken.append(ev))
        be.set_enabled(True)
        be.unblock("v1:abc", 100)   # capacity freed at index 100
        ev = _eval(status=EVAL_STATUS_BLOCKED)
        ev.class_eligibility = {"v1:abc": True}
        ev.snapshot_index = 50      # eval is older than the unblock
        be.block(ev)
        assert woken and woken[0].id == ev.id

    def test_untrack_on_job_update(self):
        be = BlockedEvals(lambda ev: None)
        be.set_enabled(True)
        ev = _eval(job_id="j", namespace="default", status=EVAL_STATUS_BLOCKED)
        be.block(ev)
        be.untrack("default", "j")
        assert be.blocked_count() == 0


class TestPlanQueue:
    def test_priority_and_future(self):
        q = PlanQueue()
        q.set_enabled(True)
        f_low = q.enqueue(Plan(priority=10))
        f_high = q.enqueue(Plan(priority=90))
        first = q.dequeue(timeout_s=1)
        assert first.plan.priority == 90
        first.future.set_result("high done")
        assert f_high.result(timeout=1) == "high done"
        second = q.dequeue(timeout_s=1)
        assert second.plan.priority == 10

    def test_disabled_rejects(self):
        q = PlanQueue()
        with pytest.raises(RuntimeError):
            q.enqueue(Plan())


# -- the port's own: requeueing evals that ran out of plan attempts -----
def test_unblock_failed_requeues_only_max_plan_evals():
    """blocked_evals.go UnblockFailed: the evals blocked because their
    scheduler ran out of plan attempts requeue; one blocked on capacity
    stays until its class frees."""
    from nomad_tpu_torch.models import TRIGGER_MAX_PLANS
    woken = []
    be = BlockedEvals(lambda ev: woken.append(ev))
    be.set_enabled(True)
    conflicts = _eval(job_id="a", status=EVAL_STATUS_BLOCKED,
                      triggered_by=TRIGGER_MAX_PLANS)
    escaped = _eval(job_id="b", status=EVAL_STATUS_BLOCKED,
                    triggered_by=TRIGGER_MAX_PLANS)
    escaped.escaped_computed_class = True
    capacity = _eval(job_id="c", status=EVAL_STATUS_BLOCKED)
    capacity.class_eligibility = {"v1:abc": True}
    for ev in (conflicts, escaped, capacity):
        be.block(ev)
    assert be.unblock_failed() == 2
    assert sorted(e.id for e in woken) == sorted([conflicts.id, escaped.id])
    assert be.blocked_count() == 1
    assert be.stats.total_escaped == 0
    be.set_enabled(False)
    assert be.unblock_failed() == 0


def test_leader_timer_requeues_max_plan_evals():
    """The leader's failed-eval unblocker runs on
    `failed_eval_unblock_delay_s` and requeues a max-plan blocked eval
    as pending through the log."""
    from nomad_tpu_torch.models import TRIGGER_MAX_PLANS
    from nomad_tpu_torch.server import Server, ServerConfig
    srv = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=300.0,
                              failed_eval_unblock_delay_s=0.1),
                 device="cpu")
    try:
        srv.start()
        ev = _eval(job_id="mp", status=EVAL_STATUS_BLOCKED,
                   triggered_by=TRIGGER_MAX_PLANS)
        srv.raft_apply("eval_update", dict(evals=[ev]))
        assert srv.blocked_evals.blocked_count() == 1
        deadline = time.time() + 5
        while time.time() < deadline and \
                srv.blocked_evals.blocked_count():
            time.sleep(0.02)
        assert srv.blocked_evals.blocked_count() == 0
        assert srv.store.eval_by_id(ev.id).status == "pending"
        assert srv.eval_broker.stats.total_ready == 1
    finally:
        srv.shutdown()
