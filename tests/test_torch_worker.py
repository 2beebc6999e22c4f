"""The reference's server tests of the eval loop against the port, their
assertions unchanged: the three server tests of tests/test_batch_worker.py
(multi-eval batching through the PRODUCTION worker: the broker's ready
queue drains into BatchGateway lanes whose kernel dispatches coalesce into
one select_many call; nomad/eval_broker.go:329 Dequeue is the reference's
amortization point), and of tests/test_microbatch.py the micro-batch
on/off placement parity, the broker's queue-wait stamp and the window-zero
half of the gateway's degeneration test. Then what the port adds: where
the server's kernels run, that a gateway on another device than the
planner raises, and that shutdown joins every thread the server started.

The port has no switches: where the reference sets
NOMAD_TPU_EVAL_BATCH=force, the server is built with gateway_window_us=0
(no micro-batch gateway, so a drain is one BatchGateway) and the
profitability question answers yes (`_force_lanes`); where it sets
NOMAD_TPU_MICROBATCH=0, gateway_window_us=0. The env half of the
degeneration test has no counterpart.

Every server is the port's on the CPU (`device="cpu"`), shut down when
its test ends, whether it passed or not.
"""

import threading
import time

import pytest
import torch

from nomad_tpu_torch import mock
from nomad_tpu_torch.ops.select import SelectKernel
from nomad_tpu_torch.server import Server as _Server, ServerConfig
from nomad_tpu_torch.utils import metrics

import test_torch_select  # noqa: F401  (torch's thread cap)

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


def _force_lanes(monkeypatch):
    """Batched lanes on the CPU, as NOMAD_TPU_EVAL_BATCH=force makes them
    in the JAX package: the cost model's answer would be no here."""
    monkeypatch.setattr(SelectKernel, "batch_dispatch_profitable",
                        lambda self, n, tolerance=1.0: True)


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


@pytest.mark.slow
def test_worker_drains_ready_queue_into_batched_dispatch(monkeypatch):
    """End-to-end through the real server: queued service evals drain
    into one batch; every job still gets its allocs; the select_many
    batched-dispatch counter moves. (Lanes are forced on — the adaptive
    heuristic would route this CPU-host shape to sequential draining —
    and the server has no micro-batch gateway, so each drain is one
    BatchGateway.)"""
    _force_lanes(monkeypatch)
    s = Server(ServerConfig(num_schedulers=1, eval_batch_size=4,
                            heartbeat_ttl_s=30.0, gateway_window_us=0))
    s.start()
    try:
        for w in s.workers:
            w.set_pause(True)
        # a worker already parked inside its 0.5s blocking dequeue only
        # notices the pause on its next loop — let that window drain or
        # it grabs the first eval the moment it lands
        time.sleep(0.7)
        for i in range(48):
            n = mock.node()
            n.name = f"bw-{i}"
            n.compute_class()
            s.register_node(n)
        def _counter(name):
            for c in metrics.snapshot()["Counters"]:
                if c["Name"] == name:
                    return c["Count"]
            return 0

        before = _counter("nomad.select.batch_dispatch")
        jobs = []
        for i in range(6):
            job = mock.job()
            job.id = f"batched-{i}"
            tg = job.task_groups[0]
            tg.count = 3
            for t in tg.tasks:
                t.resources.networks = []
            tg.networks = []
            jobs.append(job)
            s.register_job(job)
        # all six evals are READY before any worker looks
        assert s.eval_broker.stats.total_ready >= 6
        for w in s.workers:
            w.set_pause(False)
        assert _wait(lambda: all(
            len(s.store.allocs_by_job("default", j.id)) == 3
            for j in jobs)), [
                len(s.store.allocs_by_job("default", j.id)) for j in jobs]
        assert _wait(lambda: sum(w.stats["batches"]
                                 for w in s.workers) >= 1)
        after = _counter("nomad.select.batch_dispatch")
        assert after > before, "batched dispatch counter did not move"
    finally:
        s.shutdown()


@pytest.mark.slow
def test_batched_and_sequential_processing_place_identically(monkeypatch):
    """The same six jobs placed via batched lanes and via sequential
    workers end with identical per-job placement counts and identical
    per-node loading — batching must not change scheduling outcomes."""
    _force_lanes(monkeypatch)

    def run(batch_size):
        s = Server(ServerConfig(num_schedulers=1,
                                eval_batch_size=batch_size,
                                heartbeat_ttl_s=30.0,
                                gateway_window_us=0))
        s.start()
        try:
            for w in s.workers:
                w.set_pause(True)
            rng_nodes = []
            for i in range(40):
                n = mock.node()
                n.name = f"par-{i}"
                n.compute_class()
                rng_nodes.append(n)
                s.register_node(n)
            jobs = []
            for i in range(6):
                job = mock.job()
                job.id = f"parity-{i}"
                tg = job.task_groups[0]
                tg.count = 4
                for t in tg.tasks:
                    t.resources.networks = []
                tg.networks = []
                jobs.append(job)
                s.register_job(job)
            for w in s.workers:
                w.set_pause(False)
            assert _wait(lambda: all(
                len(s.store.allocs_by_job("default", j.id)) == 4
                for j in jobs))
            return {j.id: len(s.store.allocs_by_job("default", j.id))
                    for j in jobs}
        finally:
            s.shutdown()

    assert run(batch_size=6) == run(batch_size=1)


def test_gc_safepoints_worker_still_schedules():
    """ServerConfig.gc_safepoints moves CPython collections to the
    worker's between-eval safe point (server/worker.py); scheduling
    still works and gc is re-enabled for the rest of the process."""
    import gc
    import time as _time

    assert gc.isenabled()
    srv = Server(ServerConfig(num_schedulers=1, gc_safepoints=True))
    srv.start()
    try:
        srv.register_node(mock.node())
        job = mock.batch_job()
        job.task_groups[0].count = 2
        srv.register_job(job)
        deadline = _time.time() + 20
        while _time.time() < deadline:
            if len(srv.store.allocs_by_job("default", job.id)) == 2:
                break
            _time.sleep(0.05)
        assert len(srv.store.allocs_by_job("default", job.id)) == 2
        # workers restore collector state on shutdown (gcsafe refcount)
    finally:
        srv.shutdown()
    deadline = _time.time() + 5
    while _time.time() < deadline and not gc.isenabled():
        _time.sleep(0.05)
    assert gc.isenabled()


def test_window_zero_never_constructs_gateway():
    """tests/test_microbatch.py::test_window_zero_and_env_off_never_construct_gateway,
    its window-zero half (the port reads no NOMAD_TPU_MICROBATCH)."""
    s = Server(ServerConfig(gateway_window_us=0))
    assert s.gateway is None
    s3 = Server(ServerConfig())
    assert s3.gateway is not None


def test_microbatch_on_off_place_identically(monkeypatch):
    """The same jobs through micro-batching on and off end with
    identical per-job placement counts — the gateway must not change
    scheduling outcomes."""
    def run(micro: bool):
        s = Server(ServerConfig(num_schedulers=2, eval_batch_size=3,
                                heartbeat_ttl_s=30.0,
                                gateway_window_us=2000 if micro else 0))
        assert (s.gateway is not None) == micro
        s.start()
        try:
            for w in s.workers:
                w.set_pause(True)
            time.sleep(0.7)
            for i in range(24):
                node = mock.node()
                node.name = f"mb-{i}"
                node.compute_class()
                s.register_node(node)
            jobs = []
            for i in range(6):
                job = mock.job()
                job.id = f"mb-parity-{i}"
                tg = job.task_groups[0]
                tg.count = 3
                for t in tg.tasks:
                    t.resources.networks = []
                tg.networks = []
                jobs.append(job)
                s.register_job(job)
            for w in s.workers:
                w.set_pause(False)
            deadline = time.time() + 30
            while time.time() < deadline:
                if all(len(s.store.allocs_by_job("default", j.id)) == 3
                       for j in jobs):
                    break
                time.sleep(0.05)
            return {j.id: len(s.store.allocs_by_job("default", j.id))
                    for j in jobs}
        finally:
            s.shutdown()

    on = run(True)
    off = run(False)
    assert on == off
    assert all(v == 3 for v in on.values())


def test_broker_stamps_queue_wait_on_dequeue():
    from nomad_tpu_torch.models import Evaluation
    from nomad_tpu_torch.server.eval_broker import EvalBroker
    b = EvalBroker()
    b.set_enabled(True)
    try:
        ev = Evaluation(type="service", job_id="qw", status="pending")
        b.enqueue(ev)
        time.sleep(0.06)
        got, token = b.dequeue(["service"], timeout_s=1.0)
        assert got is not None
        assert got.queue_wait_s >= 0.05
        b.ack(got.id, token)
    finally:
        b.set_enabled(False)


# -- the port's own: devices and threads -------------------------------

def _place(s, jobs, timeout=30.0):
    """Register `jobs` on a started server and wait until each is placed
    to its count; returns the counts."""
    for job in jobs:
        s.register_job(job)
    want = {j.id: sum(tg.count for tg in j.task_groups) for j in jobs}
    _wait(lambda: all(len(s.store.allocs_by_job("default", j)) == n
                      for j, n in want.items()), timeout)
    return {j: len(s.store.allocs_by_job("default", j)) for j in want}


def _thread_target(t):
    """What a thread runs, for a failure message: its target's (or a
    Timer's function's) module and qualified name."""
    fn = getattr(t, "_target", None) or getattr(t, "function", None)
    if fn is None:
        return type(t).__qualname__
    return f"{getattr(fn, '__module__', '?')}." \
           f"{getattr(fn, '__qualname__', repr(fn))}"


def test_server_without_device_needs_cuda():
    """Server() with no device schedules on the card: without one it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        s = _Server(ServerConfig(num_schedulers=0))
        assert s.device.type == "cuda"
        assert s.gateway.device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        _Server(ServerConfig())


def test_cpu_server_runs_every_kernel_on_the_cpu():
    """device="cpu" reaches every kernel the server owns: the workers',
    the micro-batch gateway's and each eval lane's planner."""
    from nomad_tpu_torch.server.worker import EvalLane
    s = Server(ServerConfig(num_schedulers=2, eval_batch_size=4,
                            heartbeat_ttl_s=30.0))
    assert s.device == torch.device("cpu")
    assert s.gateway.device == torch.device("cpu")
    s.start()
    assert [w._kernel.device for w in s.workers] == [torch.device("cpu")] * 2
    lane = EvalLane(s, None, "")
    assert lane.device == torch.device("cpu")
    for i in range(8):
        n = mock.node()
        n.name = f"cpu-{i}"
        s.register_node(n)
    jobs = [mock.job() for _ in range(3)]
    for i, j in enumerate(jobs):
        j.id = f"cpu-job-{i}"
        j.task_groups[0].count = 2
    assert _place(s, jobs) == {j.id: 2 for j in jobs}


class _KernelOn:
    """A stand-in kernel that only names its device."""

    def __init__(self, device):
        self.device = torch.device(device)


def test_gateway_on_another_device_raises():
    """A gateway whose kernel runs on another device than the server's
    planners is a fault: the workers refuse it (never copy across)."""
    from nomad_tpu_torch.server import BatchGateway, MicroBatchGateway
    from nomad_tpu_torch.server.worker import check_same_device
    s = Server(ServerConfig(num_schedulers=1))
    s.gateway = MicroBatchGateway(kernel=_KernelOn("meta"))
    with pytest.raises(ValueError, match="meta"):
        s.start()
    with pytest.raises(ValueError):
        check_same_device(BatchGateway(_KernelOn("meta"), lanes=2), "cpu")
    check_same_device(BatchGateway(_KernelOn("cpu"), lanes=2), "cpu")


@pytest.mark.parametrize("cfg", [
    dict(num_schedulers=1, eval_batch_size=1, gateway_window_us=0),
    dict(num_schedulers=2, eval_batch_size=8, gateway_window_us=0),
    dict(num_schedulers=2, eval_batch_size=8),
], ids=["sequential", "drained-batches", "micro-gateway"])
def test_shutdown_joins_every_thread(cfg):
    """After shutdown no thread the server started is left: the workers,
    their finishers and lanes, the applier, the reaper, the
    tickers, the periodic dispatcher, the watchers, the heartbeat
    timers and the broker's timers.

    A thread that runs the JAX package's code is not this server's (the
    port never imports nomad_tpu) and is left out of the count: the
    reference's own tests/test_governor.py leaves EvalBrokers whose
    admission timer re-arms, a new thread every 20 ms, for the rest of
    the process, and an xdist worker may have run that file before this
    one."""
    before = set(threading.enumerate())
    s = Server(ServerConfig(heartbeat_ttl_s=30.0, **cfg))
    s.start()
    for i in range(8):
        n = mock.node()
        n.name = f"thr-{i}"
        s.register_node(n)
    jobs = [mock.job() for _ in range(4)]
    for i, j in enumerate(jobs):
        j.id = f"thr-job-{i}"
        j.task_groups[0].count = 2
    assert _place(s, jobs) == {j.id: 2 for j in jobs}
    s.shutdown()
    leftover = [t for t in threading.enumerate()
                if t not in before and t.is_alive()
                and not _thread_target(t).startswith("nomad_tpu.")]
    left = [t.name for t in leftover]
    assert not left, [f"{t.name} ({_thread_target(t)})" for t in leftover]


def test_many_workers_never_double_book_a_node():
    """Stress: more workers than cores, a short switch interval, and jobs
    that fill the nodes almost to the brim; the applier's serialization
    must hold: every job placed exactly to its count, no node over its
    CPU or memory (a lost update in the plan pipeline would double-book
    one)."""
    import os
    import sys
    n_workers = min((os.cpu_count() or 2) + 1, 12)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        s = Server(ServerConfig(num_schedulers=n_workers, eval_batch_size=2,
                                heartbeat_ttl_s=30.0))
        s.start()
        for i in range(12):
            n = mock.node()
            n.name = f"stress-{i}"
            s.register_node(n)
        jobs = [mock.job() for _ in range(24)]
        for i, j in enumerate(jobs):
            j.id = f"stress-job-{i}"
            tg = j.task_groups[0]
            tg.count = 3
            for t in tg.tasks:
                t.resources.networks = []
            tg.networks = []
        assert _place(s, jobs, timeout=60.0) == {j.id: 3 for j in jobs}
        for node in s.store.nodes():
            total = node.comparable_resources()
            reserved = node.comparable_reserved_resources()
            live = [a.allocated_resources.comparable()
                    for a in s.store.allocs_by_node(node.id)
                    if not a.terminal_status()]
            assert reserved.cpu_shares + sum(c.cpu_shares for c in live) \
                <= total.cpu_shares, node.name
            assert reserved.memory_mb + sum(c.memory_mb for c in live) \
                <= total.memory_mb, node.name
    finally:
        sys.setswitchinterval(prev)
