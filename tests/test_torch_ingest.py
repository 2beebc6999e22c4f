"""The reference's batched write ingest suite (tests/test_ingest.py): the
IngestGateway — writes arriving while a raft apply is in flight park and
land as ONE `ingest_batch` entry / store transaction / event flush, with
per-request futures demultiplexed back to each submitter — against the
port's server/ingest.py and Server on the CPU, assertions unchanged: the
1k-seed randomized parity suite, the mid-batch failure, the admission
watermarks, the trigger matrix, the window's shrink and clean-streak
recovery, the WAL round trip and restart, and the Node.UpdateAllocBatch
verb.

test_kill_switch_env_e2e_equivalence runs across the packages: the
switch (NOMAD_TPU_INGEST_BATCH=0) is set on the JAX package's side only;
the port reads no environment variable, so its off arm is
`ingest_window_us=-1`. The same scripted wave lands the same state and
per-request results on the JAX package's off server and the port's on
and off servers.

Left out, with what it waits for:
test_server_governor_exports_ingest_gauges (the governor). The two HTTP
tests (the port's api/) are at the end.
"""

import json
import random
import threading
import time
import urllib.error
import urllib.request

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)
from nomad_tpu_torch import mock
from nomad_tpu_torch.models import Allocation, Evaluation
from nomad_tpu_torch.models.alloc import DesiredTransition
from nomad_tpu_torch.server import Server as _Server, ServerConfig
from nomad_tpu_torch.server.eval_broker import AdmissionOverloadError
from nomad_tpu_torch.server.ingest import IngestGateway, SCALE_MIN
from nomad_tpu_torch.server.persistence import (RaftLog, decode_payload,
                                                encode_payload)
from nomad_tpu_torch.server.plan_applier import GROUP_RECOVER_CLEAN


def Server(config=None):
    """The port's Server on the CPU."""
    return _Server(config, device="cpu")


def _server(**kw):
    """A quiet server: no schedulers (state changes only through the
    ops under test), no background governor/telemetry churn."""
    kw.setdefault("num_schedulers", 0)
    kw.setdefault("heartbeat_ttl_s", 3600.0)
    s = Server(ServerConfig(**kw))
    s.start()
    return s


def _job(jid, count=2):
    return _job_of(mock, jid, count)


def _job_of(mock, jid, count=2):
    j = mock.job()
    j.id = jid
    j.name = jid
    j.task_groups[0].count = count
    return j


def _pool(n):
    """Deterministic alloc pool for client-update / transition ops:
    one job, n allocs with stable ids."""
    return _pool_of(mock, n)


def _pool_of(mock, n):
    pj = mock.job()
    pj.id = "ing-pool"
    pj.name = "ing-pool"
    allocs = []
    for k in range(n):
        a = mock.alloc()
        a.id = f"pool-alloc-{k:04d}"
        a.job = pj
        a.job_id = pj.id
        a.name = f"{pj.id}.web[{k}]"
        allocs.append(a)
    return pj, allocs


def _seed_pool(srv, pj, allocs):
    srv.raft_apply("job_register", dict(job=pj.copy(), evals=[]))
    srv.store.upsert_allocs(srv.store.latest_index() + 1,
                            [a.copy() for a in allocs])


def _norm_jobs(store, ids):
    out = {}
    for jid in ids:
        j = store.job_by_id("default", jid)
        out[jid] = None if j is None else (
            j.version, j.status, tuple(tg.count for tg in j.task_groups))
    return out


def _norm_allocs(store, ids):
    out = {}
    for aid in ids:
        a = store.alloc_by_id(aid)
        dt = a.desired_transition
        out[aid] = (a.client_status, a.desired_status,
                    bool(dt and dt.migrate))
    return out


def _norm_evals(store, job_ids):
    """Eval parity by shape, not id/index: ids and raft indexes differ
    between the arms by construction (fewer entries on the batched
    side), the eval SET per job must not."""
    out = {}
    for jid in job_ids:
        evs = store.evals_by_job("default", jid)
        out[jid] = sorted((e.triggered_by, e.type, e.status)
                          for e in evs)
    return out


def _norm_results(results):
    """Per-request result equivalence key: success (eval or None) vs
    the exact failure message."""
    out = []
    for r in results:
        if isinstance(r, Exception):
            out.append(("err", type(r).__name__, str(r)))
        elif r is None:
            out.append(("ok", None))
        else:
            out.append(("ok", "eval"))
    return out


# -- randomized parity (the tentpole's correctness contract) -----------

def test_randomized_ingest_parity_1k_seeds():
    """1000 random mixed write waves — bulk registers (some slots
    invalid), client alloc-update groups, desired transitions —
    submitted CONCURRENTLY through the gateway land identically to the
    sequential one-entry-per-write path: same store state, same
    per-request results, and a mid-batch validation failure fails ONLY
    its own slot. The ops within a wave touch disjoint objects, so the
    final state is interleaving-independent by construction — exactly
    the property that makes group commit safe to apply."""
    on = _server()
    off = _server(ingest_window_us=-1.0)
    assert on.ingest is not None
    assert off.ingest is None
    pj, pool = _pool(64)
    for srv in (on, off):
        _seed_pool(srv, pj, pool)
    touched_jobs, touched_allocs = {pj.id}, set()
    try:
        for seed in range(1000):
            rng = random.Random(seed)
            # three registers; every 5th seed one slot is invalid
            jobs = []
            for k in range(3):
                j = _job(f"ing-{seed}-{k}", count=rng.randint(1, 5))
                if seed % 5 == 0 and k == 1:
                    j.task_groups = []      # fails validation
                jobs.append(j)
            if seed and rng.random() < 0.3:
                # re-register from an earlier wave: the version bump
                # must survive coalescing
                jobs.append(_job(f"ing-{seed - 1}-0",
                                 count=rng.randint(1, 5)))
            picks = rng.sample(range(len(pool)), 6)
            groups = []
            for g in range(2):
                grp = []
                for i in picks[g * 2:g * 2 + 2]:
                    a = pool[i].copy()
                    a.client_status = rng.choice(
                        ["running", "failed", "complete"])
                    grp.append(a)
                groups.append(grp)
            trans = [pool[i].id for i in picks[4:]]

            res = {}
            def reg(srv, key):
                res[key] = srv.register_jobs_bulk(
                    [j.copy() for j in jobs])
            def upd(srv):
                srv.update_alloc_status_from_client_batch(
                    [[a.copy() for a in g] for g in groups])
            def stops(srv, key):
                res[key] = []
                for aid in trans:
                    try:
                        res[key].append(srv.stop_alloc(aid))
                    except Exception as e:       # pragma: no cover
                        res[key].append(e)
            # batched arm: concurrent submitters force coalescing
            threads = [threading.Thread(target=reg, args=(on, "reg_on")),
                       threading.Thread(target=upd, args=(on,)),
                       threading.Thread(target=stops, args=(on, "st_on"))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            # control arm: same wave, sequential singleton entries
            reg(off, "reg_off")
            upd(off)
            stops(off, "st_off")

            assert _norm_results(res["reg_on"]) == \
                _norm_results(res["reg_off"]), seed
            assert _norm_results(res["st_on"]) == \
                _norm_results(res["st_off"]), seed
            wave_jobs = {j.id for j in jobs}
            wave_allocs = {a.id for g in groups for a in g} | set(trans)
            assert _norm_jobs(on.store, wave_jobs) == \
                _norm_jobs(off.store, wave_jobs), seed
            assert _norm_allocs(on.store, wave_allocs) == \
                _norm_allocs(off.store, wave_allocs), seed
            touched_jobs |= wave_jobs
            touched_allocs |= wave_allocs
        # full-state sweep at the end: everything either arm ever wrote
        assert _norm_jobs(on.store, touched_jobs) == \
            _norm_jobs(off.store, touched_jobs)
        assert _norm_allocs(on.store, touched_allocs) == \
            _norm_allocs(off.store, touched_allocs)
        assert _norm_evals(on.store, touched_jobs) == \
            _norm_evals(off.store, touched_jobs)
        # the batched arm genuinely coalesced: fewer raft entries for
        # the same writes, and the gateway saw multi-entry batches
        assert on.ingest.stats["coalesced_writes"] > 0
        assert on.ingest.stats["batches"] < on.ingest.stats["requests"]
        assert on._raft_index < off._raft_index
    finally:
        on.shutdown()
        off.shutdown()


def test_bulk_register_mid_batch_failure_fails_only_its_slot():
    srv = _server()
    try:
        jobs = [_job(f"slot-{k}") for k in range(5)]
        jobs[1].task_groups = []
        jobs[3].namespace = "no-such-ns"
        out = srv.register_jobs_bulk(jobs)
        assert len(out) == 5
        assert isinstance(out[1], ValueError)
        assert "task group" in str(out[1])
        assert isinstance(out[3], ValueError)
        assert "nonexistent namespace" in str(out[3])
        for k in (0, 2, 4):
            assert isinstance(out[k], Evaluation)
            assert out[k].job_modify_index > 0
            assert srv.store.job_by_id("default", f"slot-{k}") \
                is not None
        assert srv.store.job_by_id("default", "slot-1") is None
        assert srv.store.job_by_id("default", "slot-3") is None
        # the three admitted slots parked together: one raft entry
        assert srv.ingest.stats["coalesced_writes"] >= 1
    finally:
        srv.shutdown()


# -- kill switch -------------------------------------------------------

def _jax_server(**kw):
    """The JAX package's server, as _server builds the port's."""
    from nomad_tpu.server import Server as JaxServer
    from nomad_tpu.server import ServerConfig as JaxConfig
    kw.setdefault("num_schedulers", 0)
    kw.setdefault("heartbeat_ttl_s", 3600.0)
    kw.setdefault("governor_interval_s", 3600.0)
    kw.setdefault("telemetry_sample_interval_s", 0)
    s = JaxServer(JaxConfig(**kw))
    s.start()
    return s


def test_kill_switch_env_e2e_equivalence(monkeypatch):
    """NOMAD_TPU_INGEST_BATCH=0 stops the JAX package's gateway from
    being constructed; the port's off arm is ingest_window_us=-1. The
    same scripted wave lands the same state and the same per-request
    results through the singleton path (the JAX package's off server,
    the port's off server) and through the port's gateway."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    from nomad_tpu import mock as jax_mock
    from nomad_tpu.server.ingest import INGEST_ENV, ingest_batch_enabled
    monkeypatch.setenv(INGEST_ENV, "0")
    assert not ingest_batch_enabled()
    jax_off = _jax_server()
    assert jax_off.ingest is None
    off = _server(ingest_window_us=-1.0)
    assert off.ingest is None
    on = _server()
    assert on.ingest is not None
    servers = (("jax_off", jax_off, jax_mock), ("off", off, mock),
               ("on", on, mock))
    try:
        res = {}
        for key, srv, m in servers:
            pj, pool = _pool_of(m, 4)
            _seed_pool(srv, pj, pool)
            jobs = [_job_of(m, f"ks-{k}") for k in range(4)]
            jobs[2].task_groups = []
            res[key] = srv.register_jobs_bulk([j.copy() for j in jobs])
            ups = [pool[0].copy(), pool[1].copy()]
            for a in ups:
                a.client_status = "failed"
            srv.update_alloc_status_from_client_batch([ups])
            srv.stop_alloc(pool[2].id)
        ids = {f"ks-{k}" for k in range(4)} | {"ing-pool"}
        aids = {f"pool-alloc-{k:04d}" for k in range(4)}
        for key, srv, _m in servers[1:]:
            assert _norm_results(res[key]) == _norm_results(res["jax_off"])
            assert _norm_jobs(srv.store, ids) == \
                _norm_jobs(jax_off.store, ids)
            assert _norm_allocs(srv.store, aids) == \
                _norm_allocs(jax_off.store, aids)
            assert _norm_evals(srv.store, ids) == \
                _norm_evals(jax_off.store, ids)
    finally:
        for _key, srv, _m in servers:
            srv.shutdown()


# -- admission / shed --------------------------------------------------

def test_check_admission_watermarks():
    class _Noop:
        def raft_apply(self, t, p):
            return 1
    gw = IngestGateway(_Noop(), queue_high=4)
    gw.check_admission()                        # idle: admits
    # depth watermark: fake parked entries
    gw._pending = [object()] * 4
    with pytest.raises(AdmissionOverloadError) as ei:
        gw.check_admission()
    assert ei.value.retry_after_s >= 1.0
    assert gw.stats["shed"] == 1
    # byte watermark fires on the Content-Length HINT, before decode
    gw._pending = []
    with pytest.raises(AdmissionOverloadError):
        gw.check_admission(bytes_hint=gw.queue_bytes_high + 1)
    # Retry-After scales with overshoot, capped at 8x
    gw._pending = [object()] * 400
    with pytest.raises(AdmissionOverloadError) as ei:
        gw.check_admission()
    assert ei.value.retry_after_s == 8.0


# -- trigger matrix ----------------------------------------------------

class _FakeRaft:
    """Records applies; an optional gate stalls the first apply so
    later submissions demonstrably park behind it."""

    def __init__(self):
        self.applies = []
        self.gate = None
        self.entered = threading.Event()
        self._l = threading.Lock()

    def raft_apply(self, msg_type, payload):
        self.entered.set()
        if self.gate is not None:
            self.gate.wait(5)
        with self._l:
            self.applies.append((msg_type, payload))
            return len(self.applies)


def _drain_gw(gw, want, timeout=5.0):
    import time
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if gw.stats["requests"] - gw.stats["entries_sum"] == 0 and \
                gw.stats["entries_sum"] >= want:
            return
        time.sleep(0.005)
    raise AssertionError(f"gateway never drained: {gw.stats}")


def test_trigger_immediate_singleton_keeps_entry_kind():
    fake = _FakeRaft()
    gw = IngestGateway(fake, window_us=50_000)
    gw.start()
    try:
        idx = gw.submit("job_register", {"job": "j", "evals": []})
        assert idx == 1
        assert fake.applies == [("job_register",
                                 {"job": "j", "evals": []})]
        assert gw.stats["immediate_dispatches"] == 1
        assert gw.stats["coalesced_writes"] == 0
    finally:
        gw.stop()


def test_trigger_drain_coalesces_parked_writes_into_one_entry():
    fake = _FakeRaft()
    fake.gate = threading.Event()
    gw = IngestGateway(fake, window_us=50_000)
    gw.start()
    try:
        first = gw.submit_async("job_register", {"job": 0, "evals": []})
        # wait until the first apply is demonstrably in flight, THEN
        # park five writes behind it — the apply is their window
        assert fake.entered.wait(5)
        futs = [gw.submit_async("alloc_client_update", {"allocs": [k]})
                for k in range(5)]
        fake.gate.set()
        fake.gate = None
        indexes = {f.result(timeout=5) for f in futs}
        assert first.result(timeout=5) == 1
        # all five demuxed to the SAME commit index, one batch entry
        assert indexes == {2}
        kinds = [t for t, _ in fake.applies]
        assert kinds == ["job_register", "ingest_batch"]
        entries = fake.applies[1][1]["entries"]
        assert [e["kind"] for e in entries] == \
            ["alloc_client_update"] * 5
        assert gw.stats["drain_dispatches"] >= 1
        assert gw.stats["coalesced_writes"] == 4
    finally:
        gw.stop()


def test_trigger_occupancy_fires_at_batch_max():
    fake = _FakeRaft()
    fake.gate = threading.Event()
    gw = IngestGateway(fake, batch_max=4, window_us=5_000_000)
    gw.start()
    try:
        futs = [gw.submit_async("job_register", {"job": k, "evals": []})
                for k in range(9)]
        fake.gate.set()
        fake.gate = None
        for f in futs:
            f.result(timeout=5)
        _drain_gw(gw, want=9)
        sizes = [len(p.get("entries", [None]))
                 for _t, p in fake.applies]
        assert max(sizes) == 4          # occupancy cap respected
        assert gw.stats["occupancy_dispatches"] >= 1
    finally:
        gw.stop()


def test_submit_rejects_unknown_kind_and_stop_fails_futures():
    fake = _FakeRaft()
    gw = IngestGateway(fake)
    with pytest.raises(ValueError):
        gw.submit_async("node_register", {})
    # never started (library/test servers that skip Server.start()):
    # the caller thread commits its own singleton synchronously —
    # nothing parks forever behind a thread that does not exist
    fut = gw.submit_async("job_register", {"job": "j", "evals": []})
    assert fut.result(timeout=1) == 1
    assert [t for t, _ in fake.applies] == ["job_register"]
    gw.stop()
    with pytest.raises(RuntimeError):
        gw.submit_async("job_register", {})


def test_stop_fails_parked_futures():
    fake = _FakeRaft()
    fake.gate = threading.Event()
    gw = IngestGateway(fake, window_us=50_000)
    gw.start()
    first = gw.submit_async("job_register", {"job": 0, "evals": []})
    assert fake.entered.wait(5)
    parked = gw.submit_async("alloc_client_update", {"allocs": []})
    stopper = threading.Thread(target=gw.stop)
    stopper.start()
    # the stop flag must be up BEFORE the apply unblocks, or the loop
    # would legitimately drain the parked write as its next batch
    deadline = time.monotonic() + 5
    while not gw._stopped and time.monotonic() < deadline:
        time.sleep(0.005)
    assert gw._stopped
    fake.gate.set()
    fake.gate = None
    stopper.join(timeout=10)
    assert not stopper.is_alive()
    assert first.result(timeout=5) == 1     # in-flight apply lands
    with pytest.raises(RuntimeError):       # parked write fails on stop
        parked.result(timeout=5)


def test_commit_failure_fails_every_parked_future():
    class _Boom:
        def raft_apply(self, t, p):
            raise RuntimeError("wal is on fire")
    gw = IngestGateway(_Boom())
    gw.start()
    try:
        fut = gw.submit_async("job_register", {"job": "j", "evals": []})
        with pytest.raises(RuntimeError, match="wal is on fire"):
            fut.result(timeout=5)
    finally:
        gw.stop()


# -- governor coupling -------------------------------------------------

def test_governor_shrink_window_and_clean_streak_recovery():
    gw = IngestGateway(_FakeRaft(), window_us=800.0)
    base = gw.window_us()
    assert base == pytest.approx(800.0)
    out = gw.shrink_window()
    assert out["was_us"] == pytest.approx(800.0)
    assert gw.window_us() == pytest.approx(400.0)
    for _ in range(10):
        gw.shrink_window()
    assert gw.window_us() == pytest.approx(800.0 * SCALE_MIN)
    # a clean streak under the watermark re-widens one step at a time
    for _ in range(GROUP_RECOVER_CLEAN):
        gw._note_batch(2, 0.0, "drain")
    assert gw.window_us() == pytest.approx(800.0 * SCALE_MIN * 2)
    while gw.window_us() < base:
        for _ in range(GROUP_RECOVER_CLEAN):
            gw._note_batch(2, 0.0, "drain")
    assert gw.window_us() == pytest.approx(base)


# -- WAL round-trip ----------------------------------------------------

def test_ingest_batch_payload_codec_roundtrip():
    """encode_payload/decode_payload on a mixed-kind batch entry: each
    sub-entry encodes under its own kind's schema, survives JSON, and
    decodes back to real models with the kind tag intact."""
    job = _job("wal-rt")
    ev = Evaluation(namespace="default", job_id=job.id, type=job.type,
                    priority=50, triggered_by="job-register",
                    status="pending")
    a = mock.alloc()
    a.client_status = "failed"
    entries = [
        dict(kind="job_register", job=job, evals=[ev]),
        dict(kind="alloc_client_update", allocs=[a], evals=[]),
        dict(kind="alloc_desired_transition", alloc_ids=[a.id],
             transition=DesiredTransition(migrate=True), evals=[]),
    ]
    enc = encode_payload("ingest_batch", {"entries": entries})
    enc = json.loads(json.dumps(enc))        # must be wire-clean
    dec = decode_payload("ingest_batch", enc)
    d0, d1, d2 = dec["entries"]
    assert d0["kind"] == "job_register"
    assert d0["job"].id == job.id
    assert d0["job"].task_groups[0].count == job.task_groups[0].count
    assert d0["evals"][0].job_id == job.id
    assert d1["kind"] == "alloc_client_update"
    assert d1["allocs"][0].id == a.id
    assert d1["allocs"][0].client_status == "failed"
    assert d2["kind"] == "alloc_desired_transition"
    assert d2["alloc_ids"] == [a.id]
    assert d2["transition"].migrate is True


def test_ingest_batch_wal_entry_survives_restart(tmp_path):
    """A multi-entry ingest_batch lands in the WAL as ONE frame; replay
    on restart reapplies the whole group — jobs, allocs, and the
    apply-time-stamped eval fences all come back."""
    data_dir = str(tmp_path / "ingest-wal")
    srv = _server(data_dir=data_dir)
    pj, pool = _pool(2)
    # the pool must reach the WAL (plan entry), not just the live
    # store, or replay has nothing for the client update to merge into
    srv.raft_apply("job_register", dict(job=pj.copy(), evals=[]))
    srv.raft_apply("plan_results", dict(
        allocs_stopped=[], allocs_preempted=[],
        allocs_placed=[a.copy() for a in pool]))
    jobs = [_job(f"wal-{k}") for k in range(2)]
    evs = [Evaluation(namespace="default", job_id=j.id, type=j.type,
                      priority=50, triggered_by="job-register",
                      status="pending") for j in jobs]
    up = pool[0].copy()
    up.client_status = "complete"
    entries = [dict(kind="job_register", job=jobs[0], evals=[evs[0]]),
               dict(kind="job_register", job=jobs[1], evals=[evs[1]]),
               dict(kind="alloc_client_update", allocs=[up], evals=[])]
    index = srv.raft_apply("ingest_batch", {"entries": entries})
    # plus a gateway-built batch over the live bulk path
    out = srv.register_jobs_bulk([_job(f"wal-live-{k}")
                                  for k in range(4)])
    assert all(isinstance(r, Evaluation) for r in out)
    srv.shutdown()

    frames = RaftLog(str(tmp_path / "ingest-wal" / "raft.log")).replay()
    batch_frames = [(i, t, p) for i, t, p, *_ in frames
                    if t == "ingest_batch"]
    assert batch_frames, "no ingest_batch frame reached the WAL"
    assert len(batch_frames[0][2]["entries"]) == 3

    srv2 = Server(ServerConfig(num_schedulers=0, data_dir=data_dir))
    try:
        for j in jobs:
            assert srv2.store.job_by_id("default", j.id) is not None
            evs2 = srv2.store.evals_by_job("default", j.id)
            assert len(evs2) == 1
            # the embedded eval's fence was stamped at apply time and
            # replays deterministically
            assert evs2[0].job_modify_index == index
        assert srv2.store.alloc_by_id(pool[0].id).client_status == \
            "complete"
        for k in range(4):
            assert srv2.store.job_by_id("default",
                                        f"wal-live-{k}") is not None
        assert srv2._raft_index >= index
    finally:
        srv2.shutdown()


# -- RPC verb ----------------------------------------------------------

def test_node_update_alloc_batch_rpc_verb():
    """Node.UpdateAllocBatch pushes N clients' update groups in ONE
    wire call; the decoded groups land through the batch path."""
    from nomad_tpu_torch.rpc.server import build_method_table
    from nomad_tpu_torch.utils.codec import to_wire
    srv = _server()
    pj, pool = _pool(4)
    _seed_pool(srv, pj, pool)
    try:
        table = build_method_table(srv)
        assert "Node.UpdateAllocBatch" in table
        groups = []
        for k in range(2):
            a = pool[k].copy()
            a.client_status = "running"
            groups.append([to_wire(a)])
        out = table["Node.UpdateAllocBatch"]({"updates": groups})
        assert out["groups"] == 2
        for k in range(2):
            assert srv.store.alloc_by_id(pool[k].id).client_status == \
                "running"
    finally:
        srv.shutdown()


# -- the HTTP write path (the reference's) ----------------------------
def test_http_shed_429_before_decode():
    """Over the forced watermark the HTTP write path sheds with 429 +
    Retry-After — and BEFORE body decode: a garbage body is refused
    with 429, not a 400 parse error."""
    from nomad_tpu_torch.api import ApiClient, ApiError, HTTPApiServer
    from nomad_tpu_torch.jobspec import job_to_spec
    srv = _server()
    api = HTTPApiServer(srv, port=0)
    api.start()
    c = ApiClient(f"http://127.0.0.1:{api.port}")
    try:
        ing = srv.ingest
        shed0 = ing.stats["shed"]
        # force the byte watermark: queued-bytes accounting is only
        # touched by the gateway when real entries move, so pinning it
        # over the high mark sheds every write without feeding the
        # gateway loop fake entries
        ing._pending_bytes = ing.queue_bytes_high + 1
        with pytest.raises(ApiError) as ei:
            c.register_job(job_to_spec(_job("shed-job")))
        assert ei.value.status == 429
        assert "overloaded" in str(ei.value)
        # raw request: the Retry-After header rides the refusal, and a
        # body that would NOT decode is never decoded (shed comes
        # first — 429, not 400)
        req = urllib.request.Request(
            f"http://127.0.0.1:{api.port}/v1/jobs",
            data=b"this is not json", method="PUT",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as hei:
            urllib.request.urlopen(req, timeout=30)
        assert hei.value.code == 429
        assert float(hei.value.headers["Retry-After"]) >= 1
        assert ing.stats["shed"] >= shed0 + 2
        # below the watermark writes admit again
        ing._pending_bytes = 0
        out = c.register_job(job_to_spec(_job("shed-job")))
        assert out["EvalID"]
    finally:
        api.shutdown()
        srv.shutdown()


def test_http_bulk_register_array_body():
    from nomad_tpu_torch.api import ApiClient, HTTPApiServer
    from nomad_tpu_torch.jobspec import job_to_spec
    srv = _server()
    api = HTTPApiServer(srv, port=0)
    api.start()
    c = ApiClient(f"http://127.0.0.1:{api.port}")
    try:
        specs = [job_to_spec(_job(f"bulk-{k}")) for k in range(6)]
        bad = job_to_spec(_job("bulk-bad"))
        bad["task_groups"] = []
        specs.insert(3, bad)
        out = c.register_jobs_bulk(specs)
        assert len(out) == 7
        assert "Error" in out[3]
        for i, r in enumerate(out):
            if i == 3:
                continue
            assert r["EvalID"]
            assert r["JobModifyIndex"] > 0
        # EnforceIndex is a per-job CAS — rejected per-slot in bulk
        out2 = c.register_jobs_bulk(
            [{"Job": job_to_spec(_job("bulk-cas")),
              "EnforceIndex": True, "JobModifyIndex": 0}])
        assert "EnforceIndex" in out2[0]["Error"]
    finally:
        api.shutdown()
        srv.shutdown()
