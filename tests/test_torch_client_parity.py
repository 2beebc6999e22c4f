"""The port's node agent against the JAX package's, on the CPU.

Each package runs its own Server (the port's with device="cpu", the JAX
package's under JAX_PLATFORMS=cpu) and Clients with the mock driver in
this process, over the same seeded inputs (mock ids from
`seeded_mock_ids`, the nodes' capacities and the jobs' counts from a
seeded `random.Random`), one step at a time:

- the clients' Node records (attributes, resources and drivers, ids and
  the client RPC address aside);
- a batch job of count 2 running to complete;
- a service job stopped on deregister;
- a failing task's reschedule eval;
- a blocked eval that a joining node wakes;
- a configured device group (`ClientConfig(devices=...)`), with the
  instance ids on the allocs;
- a rolling deployment marked successful by the clients' health;
- a drain that migrates every alloc off its node.

Compared: the allocs by (name, node name) with their client and desired
statuses, the sequence of task-state event types and the device
instance ids, the evals' triggers and statuses, the job summaries and
the deployments' statuses, exactly; the allocs' scores within 1e-6.
Every wait has a deadline and fails naming what it waited for.

Besides: `fingerprint_accelerator_devices()` is [] in both packages on
the CPU, and each package's client state DB writes byte-identical files
that the other package's Client restores.
"""

import json
import random
import time

import numpy as np
import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

SEEDS = (1, 2, 3)
DEADLINE_S = 30.0
CAPACITIES = ((4000, 8192), (6000, 12288), (8000, 16384))


def _packages(port: bool):
    if port:
        from nomad_tpu_torch import client, mock, models
        from nomad_tpu_torch.models.job import UpdateStrategy
        from nomad_tpu_torch.models.node import DrainSpec, DrainStrategy
        from nomad_tpu_torch.server import Server, ServerConfig
    else:
        from nomad_tpu import client, mock, models
        from nomad_tpu.models.job import UpdateStrategy
        from nomad_tpu.models.node import DrainSpec, DrainStrategy
        from nomad_tpu.server import Server, ServerConfig
    return dict(client=client, mock=mock, models=models,
                Server=Server, ServerConfig=ServerConfig,
                UpdateStrategy=UpdateStrategy, DrainSpec=DrainSpec,
                DrainStrategy=DrainStrategy)


def _wait(pred, what, deadline_s=DEADLINE_S):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"{what}: not reached in {deadline_s} s")


def _plan(seed):
    """The seed's choices, equal for both packages."""
    rng = random.Random(seed)
    caps = list(CAPACITIES)
    rng.shuffle(caps)
    return dict(caps=caps, device_node=rng.randrange(3),
                batch_count=2, service_count=rng.randint(2, 3),
                deploy_count=rng.randint(2, 3))


def _job(p, kind, job_id, count, run_for):
    mock = p["mock"]
    job = mock.batch_job() if kind == "batch" else mock.job()
    job.id = job.name = job_id
    job.constraints = []
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = []
    tg.services = []
    for t in tg.tasks:
        t.driver = "mock_driver"
        t.config = {"run_for": run_for}
        t.services = []
        t.resources.networks = []
    return job


def _node_record(node):
    attrs = {k: v for k, v in node.attributes.items()
             if k != "nomad.client.rpc"}
    res = node.node_resources
    devices = sorted(
        (g.vendor, g.type, g.name, tuple(sorted(i.id for i in g.instances)))
        for g in res.devices)
    drivers = sorted((name, d.detected, d.healthy)
                     for name, d in node.drivers.items())
    return dict(attributes=attrs, cpu=res.cpu.cpu_shares,
                memory=res.memory.memory_mb, disk=res.disk.disk_mb,
                networks=sorted((n.mode, n.device, n.ip, n.mbits)
                                for n in res.networks),
                devices=devices, drivers=drivers,
                datacenter=node.datacenter, status=node.status)


def _job_outcome(s, job_id):
    store = s.store
    names = {n.id: n.name for n in store.nodes()}
    allocs = []
    scores = {}
    for a in store.allocs_by_job("default", job_id):
        events = {t: [e.type for e in (st.events or [])]
                  for t, st in sorted((a.task_states or {}).items())}
        devs = []
        if a.allocated_resources is not None:
            for t, tr in sorted(a.allocated_resources.tasks.items()):
                for d in tr.devices:
                    devs.append((t, d.vendor, d.type, d.name,
                                 tuple(d.device_ids)))
        allocs.append((a.name, names.get(a.node_id), a.client_status,
                       a.desired_status, json.dumps(events), tuple(devs)))
        if a.metrics is not None:
            scores.setdefault(a.name, []).append(sorted(
                (names.get(sm.node_id), sm.norm_score)
                for sm in a.metrics.score_meta_data))
    evals = [(e.triggered_by, e.status)
             for e in sorted(store.evals_by_job("default", job_id),
                             key=lambda e: (e.create_index, e.id))]
    summ = store.job_summary("default", job_id)
    summary = {} if summ is None else {
        tg: dict(sorted(counts.items()))
        for tg, counts in sorted(summ.summary.items())}
    deployments = [(d.job_version, d.status)
                   for d in sorted(store.deployments_by_job("default",
                                                            job_id),
                                   key=lambda d: d.create_index)]
    return dict(allocs=sorted(allocs), evals=evals, summary=summary,
                deployments=deployments), scores


def _run(port, seed, monkeypatch):
    """One package's cluster through every step; returns (outcome,
    scores)."""
    p = _packages(port)
    client, models = p["client"], p["models"]
    plan = _plan(seed)
    out, scores = {}, {}
    kw = dict(device="cpu") if port else {}
    if not port:
        monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    s = p["Server"](p["ServerConfig"](num_schedulers=1,
                                      heartbeat_ttl_s=3600.0), **kw)
    s.start()
    clients = []

    def join(name, cpu, mem, devices=()):
        c = client.Client(s, client.ClientConfig(
            node_name=name, cpu_shares=cpu, memory_mb=mem,
            devices=devices, stats_sample_interval_s=0.0))
        c.start()
        clients.append(c)
        _wait(lambda: (n := s.store.node_by_id(c.node.id)) is not None
              and n.status == "ready", f"node {name} ready")
        return c

    def done(job_id, n, status):
        def pred():
            allocs = s.store.allocs_by_job("default", job_id)
            return len(allocs) == n and all(
                a.client_status == status for a in allocs)
        _wait(pred, f"{job_id}: {n} allocs {status}")

    try:
        with p["mock"].seeded_mock_ids(seed):
            for i, (cpu, mem) in enumerate(plan["caps"]):
                devices = ()
                if i == plan["device_node"]:
                    devices = (models.NodeDeviceResource(
                        vendor="nvidia", type="gpu", name="h100",
                        attributes={"count": 4},
                        instances=[models.NodeDevice(id=f"gpu-{k}",
                                                     healthy=True)
                                   for k in range(4)]),)
                join(f"c{i}", cpu, mem, devices)
            out["nodes"] = {n.name: _node_record(n)
                            for n in s.store.nodes()}

            # a batch job running to complete
            job = _job(p, "batch", "batch", plan["batch_count"], "50ms")
            s.register_job(job)
            done("batch", plan["batch_count"], "complete")

            # a service job stopped on deregister
            job = _job(p, "service", "svc", plan["service_count"], "60s")
            s.register_job(job)
            done("svc", plan["service_count"], "running")
            s.deregister_job("default", "svc")
            done("svc", plan["service_count"], "complete")

            # a failing task: its alloc fails, its reschedule eval places
            # one replacement, which fails too
            job = _job(p, "batch", "fail", 1, "50ms")
            tg = job.task_groups[0]
            tg.tasks[0].config = {"run_for": "50ms", "exit_code": 1}
            tg.restart_policy.attempts = 0
            tg.restart_policy.mode = "fail"
            tg.reschedule_policy.attempts = 1
            tg.reschedule_policy.delay_s = 0.0
            tg.reschedule_policy.interval_s = 600.0
            tg.reschedule_policy.unlimited = False
            s.register_job(job)
            done("fail", 2, "failed")
            _wait(lambda: all(
                e.status == "complete"
                for e in s.store.evals_by_job("default", "fail")),
                "fail: every eval complete")

            # a device group: two allocs of two instances each
            job = _job(p, "batch", "dev", 2, "50ms")
            job.task_groups[0].tasks[0].resources.devices = [
                models.RequestedDevice(name="gpu", count=2)]
            s.register_job(job)
            done("dev", 2, "complete")

            # a blocked eval that a joining node wakes
            job = _job(p, "batch", "big", 1, "50ms")
            job.task_groups[0].tasks[0].resources.cpu = 12000
            s.register_job(job)
            _wait(lambda: s.blocked_evals.blocked_count() == 1,
                  "big: one blocked eval")
            join("big-node", 16000, 32768)
            done("big", 1, "complete")

            # a rolling deployment marked successful by the clients
            job = _job(p, "service", "roll", plan["deploy_count"], "120s")
            tg = job.task_groups[0]
            tg.restart_policy.attempts = 0
            tg.restart_policy.mode = "fail"
            tg.update = p["UpdateStrategy"](
                max_parallel=plan["deploy_count"], min_healthy_time_s=0.05,
                healthy_deadline_s=10.0, progress_deadline_s=30.0)
            job.canonicalize()
            s.register_job(job)

            def deployed(version):
                d = s.store.latest_deployment_by_job("default", "roll")
                return d is not None and d.job_version == version and \
                    d.status == "successful"
            _wait(lambda: deployed(0), "roll: version 0 successful")
            v1 = s.store.job_by_id("default", "roll").copy()
            v1.task_groups[0].tasks[0].config = {"run_for": "119s"}
            s.register_job(v1)
            _wait(lambda: deployed(1), "roll: version 1 successful")

            # a drain that migrates every alloc off its node
            def live(node_id):
                return [a for a in s.store.allocs_by_node(node_id)
                        if not a.client_terminal_status()
                        and a.job_id == "roll"]
            target = max(s.store.nodes(),
                         key=lambda n: (len(live(n.id)), n.name))
            s.update_node_drain(target.id, p["DrainStrategy"](
                drain_spec=p["DrainSpec"](deadline_s=60.0)))
            _wait(lambda: not live(target.id), "drain: node emptied")
            _wait(lambda: sum(
                a.client_status == "running" and not a.server_terminal_status()
                for a in s.store.allocs_by_job("default", "roll"))
                == plan["deploy_count"], "drain: replacements running")
            _wait(lambda: s.store.node_by_id(target.id).drain_strategy
                  is None, "drain: complete")

        for job_id in ("batch", "svc", "fail", "dev", "big", "roll"):
            out[job_id], scores[job_id] = _job_outcome(s, job_id)
        out["drained"] = target.name
    finally:
        for c in clients:
            c.shutdown()
        s.shutdown()
    return out, scores


@pytest.mark.parametrize("seed", SEEDS)
def test_clients_run_jobs_as_the_jax_clients(monkeypatch, seed):
    want, want_scores = _run(False, seed, monkeypatch)
    got, got_scores = _run(True, seed, monkeypatch)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    # the failing task rescheduled; the device allocs hold instances
    assert any(t == "alloc-failure" for t, _st in want["fail"]["evals"])
    assert all(a[5] for a in want["dev"]["allocs"])
    assert {d[1] for d in want["roll"]["deployments"]} == {"successful"}
    for job_id, ws in want_scores.items():
        gs = got_scores[job_id]
        assert gs.keys() == ws.keys(), job_id
        for name in ws:
            for g, w in zip(gs[name], ws[name]):
                assert [n for n, _ in g] == [n for n, _ in w], name
                np.testing.assert_allclose([v for _, v in g],
                                           [v for _, v in w],
                                           rtol=1e-6, atol=1e-6)


def test_no_accelerator_on_the_cpu(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    from nomad_tpu.client.agent import \
        fingerprint_accelerator_devices as jax_fp
    from nomad_tpu_torch.client.agent import \
        fingerprint_accelerator_devices as port_fp
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert jax_fp() == [] and port_fp() == []


def _fake_cuda_host(monkeypatch, init):
    """torch with a CUDA build on a host that shows an NVIDIA card, whose
    torch.cuda.init is `init`."""
    import torch
    from nomad_tpu_torch.client import agent
    monkeypatch.setattr(torch.backends.cuda, "is_built", lambda: True)
    monkeypatch.setattr(agent, "_host_has_nvidia_device", lambda: True)
    monkeypatch.setattr(torch.cuda, "init", init)
    return agent, torch


def test_accelerator_fingerprint_raises_a_failed_cuda_init(monkeypatch):
    """On a host with an NVIDIA card a CUDA error raises: the node is not
    left without its cards."""
    def broken():
        raise RuntimeError("CUDA driver initialization failed")
    agent, _torch = _fake_cuda_host(monkeypatch, broken)
    with pytest.raises(RuntimeError, match="initialization failed"):
        agent.fingerprint_accelerator_devices()
    # without a card on the host (or without a CUDA build) there is
    # nothing to initialise and the node has no device group
    monkeypatch.setattr(agent, "_host_has_nvidia_device", lambda: False)
    assert agent.fingerprint_accelerator_devices() == []


def test_accelerator_fingerprint_lists_the_cards(monkeypatch):
    agent, torch = _fake_cuda_host(monkeypatch, lambda: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    [g] = agent.fingerprint_accelerator_devices()
    assert (g.vendor, g.type, g.name) == ("nvidia", "gpu",
                                          "nvidia-h100-80gb-hbm3")
    assert g.attributes == {"count": 2}
    assert [d.id for d in g.instances] == ["gpu-0", "gpu-1"]
    assert all(d.healthy for d in g.instances)


def _write_state(p, state_dir, seed):
    """Identity, an alloc and its task's state through one package's
    ClientStateDB, a compaction between them."""
    from importlib import import_module
    pkg = "nomad_tpu_torch" if p["mock"].__name__.startswith(
        "nomad_tpu_torch") else "nomad_tpu"
    state_db = import_module(f"{pkg}.client.state_db")
    models = p["models"]
    with p["mock"].seeded_mock_ids(seed):
        alloc = p["mock"].alloc()
        node_id = p["mock"].node().id
    db = state_db.ClientStateDB(str(state_dir))
    db.save_identity(node_id, "secret-" + node_id[:8])
    db.put_alloc(alloc)
    db.compact()
    st = models.TaskState(state="running")
    db.put_task(alloc.id, "web", st, {"pid": 42, "driver": "mock_driver"},
                {"token": "s.x", "accessor": "a"})
    db.close()
    return node_id, alloc.id


@pytest.mark.parametrize("seed", SEEDS)
def test_client_state_files_cross_restore(tmp_path, monkeypatch, seed):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    sides = {"jax": _packages(False), "port": _packages(True)}
    written = {}
    for name, p in sides.items():
        d = tmp_path / name
        written[name] = (d, _write_state(p, d, seed))
        # stable wire ids: the mock's ids are seeded, equal on both sides
    assert written["jax"][1] == written["port"][1]
    for fname in ("client.json", "state.snap.json", "state.journal"):
        a, b = (written[n][0] / fname for n in ("jax", "port"))
        assert a.exists() == b.exists(), fname
        if a.exists():
            assert a.read_bytes() == b.read_bytes(), fname
    # each package's Client restores the other's files
    for reader, writer in (("port", "jax"), ("jax", "port")):
        p = sides[reader]
        d, (node_id, alloc_id) = written[writer]
        kw = dict(device="cpu") if reader == "port" else {}
        s = p["Server"](p["ServerConfig"](num_schedulers=0), **kw)
        c = p["client"].Client(s, p["client"].ClientConfig(
            node_name="restored", state_dir=str(d), rpc_port=None,
            stats_sample_interval_s=0.0))
        try:
            assert c.node.id == node_id
            rec = c.state_db.state[alloc_id]
            assert rec["tasks"]["web"]["handle"] == {
                "pid": 42, "driver": "mock_driver"}
            assert rec["tasks"]["web"]["state"]["state"] == "running"
            alloc = rec["alloc"]
            assert alloc["id"] == alloc_id
        finally:
            c.shutdown()
            s.shutdown()
