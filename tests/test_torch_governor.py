"""The reference's steady-state governor suite (tests/test_governor.py)
against the port's governor/, broker, event broker, state store, kernel
layer and Server (on the CPU), its assertions unchanged: watermark
policies, drift detection, accounting registry + reclamation,
backpressure shed/requeue at the eval broker, event-broker byte
bounding, state-store layer compaction, kernel-cache bounds, and the
operator surface (/v1/operator/governor, `operator governor`).

Mapped: TestKernelCacheGovernance. The JAX package's kernel caches are
two shape-keyed jit LRUs ("scan_batched", "chunked_batched") and jax's
per-function caches; the port compiles no kernel per shape, and
kernel_cache_stats counts what it holds instead (the loaded library and
the sharded kernels' route memos, ops/kernels.py cache_entries). The
test holds the same contract on those keys: the bound is positive, the
entries are the stats' sum, the reclaim evicts the memos and leaves
them empty.
"""

import time

import pytest

from nomad_tpu_torch.governor import (DriftDetector, GaugeRegistry, Governor,
                                RollingSeries, WatermarkPolicy)
from nomad_tpu_torch.governor.policy import STATUS_OK, STATUS_OVER
from nomad_tpu_torch.models import Evaluation
from nomad_tpu_torch.server import EvalBroker
from nomad_tpu_torch.server.event_broker import (Event, EventBroker,
                                           approx_event_bytes)
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.server import Server as _Server
import test_torch_select  # noqa: F401  (torch's thread cap)


def Server(config=None, **kw):
    # the port's Server on the CPU: the kernels' plain versions
    return _Server(config, device="cpu", **kw)


def _eval(job_id="job1", typ="service", **kw):
    return Evaluation(job_id=job_id, priority=50, type=typ, **kw)


# -- watermark policy --------------------------------------------------

class TestWatermarkPolicy:
    def test_hysteresis(self):
        wm = WatermarkPolicy(high=100.0, low=80.0)
        assert wm.next_status(STATUS_OK, 99.0) == STATUS_OK
        assert wm.next_status(STATUS_OK, 100.0) == STATUS_OVER
        # over stays over in the band between low and high
        assert wm.next_status(STATUS_OVER, 90.0) == STATUS_OVER
        assert wm.next_status(STATUS_OVER, 80.0) == STATUS_OK

    def test_default_low(self):
        wm = WatermarkPolicy(high=1000.0)
        assert wm.low == pytest.approx(800.0)

    def test_invalid_low(self):
        with pytest.raises(ValueError):
            WatermarkPolicy(high=10.0, low=20.0)


# -- drift detector ----------------------------------------------------

class TestDriftDetector:
    def test_flat_series_no_drift(self):
        d = DriftDetector(window=60, min_samples=10, ratio_max=1.5)
        for i in range(40):
            d.observe_perf("p99", float(i), 50.0 + (i % 3))
        assert d.check() == []

    def test_upward_drift_detected_with_suspect(self):
        d = DriftDetector(window=60, min_samples=10, ratio_max=1.5)
        for i in range(40):
            d.observe_perf("p99", float(i), 50.0 + 5.0 * i)
            # one structure grows with the drift, one stays flat
            d.observe_struct("event_buffer", float(i), 1000.0 + 100.0 * i)
            d.observe_struct("plan_queue", float(i), 5.0)
        findings = d.check()
        assert len(findings) == 1
        f = findings[0]
        assert f["kind"] == "drift"
        assert f["metric"] == "p99"
        assert f["ratio"] > 1.5
        assert f["suspect_structure"] == "event_buffer"

    def test_downward_throughput_drift(self):
        d = DriftDetector(window=60, min_samples=10, ratio_max=1.5)
        for i in range(40):
            d.observe_perf("thr", float(i), 1000.0 - 20.0 * i,
                           degrades="down")
        findings = d.check()
        assert [f["metric"] for f in findings] == ["thr"]

    def test_min_samples_gate(self):
        d = DriftDetector(window=60, min_samples=30, ratio_max=1.5)
        for i in range(10):
            d.observe_perf("p99", float(i), 50.0 * (i + 1))
        assert d.check() == []

    def test_rolling_series_slope(self):
        s = RollingSeries(maxlen=100)
        # 1 unit per second == 3600/hour
        for i in range(20):
            s.add(float(i), float(i))
        assert s.slope_per_hour() == pytest.approx(3600.0)


# -- registry + reclamation -------------------------------------------

class TestGaugeRegistry:
    def test_sample_updates_value_and_metrics(self):
        reg = GaugeRegistry()
        v = {"x": 5.0}
        reg.register("t.gauge", lambda: v["x"])
        regs = reg.sample(now=0.0)
        assert regs[0].value == 5.0
        from nomad_tpu_torch.utils import metrics
        gauges = {g["Name"]: g["Value"]
                  for g in metrics.snapshot()["Gauges"]}
        assert gauges["nomad.governor.t.gauge"] == 5.0

    def test_reclaim_fires_over_watermark_and_rate_limits(self):
        reg = GaugeRegistry()
        v = {"x": 0.0}
        calls = []
        reg.register("t.bounded", lambda: v["x"],
                     WatermarkPolicy(high=10.0,
                                     min_reclaim_interval_s=100.0),
                     reclaim=lambda: calls.append(1))
        reg.sample(now=1.0)
        assert calls == []
        v["x"] = 50.0
        reg.sample(now=2.0)
        assert calls == [1]
        # rate limited: still over, but inside min_reclaim_interval_s
        reg.sample(now=3.0)
        assert calls == [1]
        # past the interval it fires again
        reg.sample(now=200.0)
        assert calls == [1, 1]

    def test_broken_gauge_is_isolated(self):
        reg = GaugeRegistry()

        def boom():
            raise RuntimeError("x")
        reg.register("a.bad", boom)
        good = reg.register("b.good", lambda: 7.0)
        reg.sample(now=0.0)
        assert good.value == 7.0
        assert reg.get("a.bad").errors == 1


# -- governor: backpressure + events ----------------------------------

class TestGovernor:
    def test_backpressure_engages_and_releases(self):
        gov = Governor()
        v = {"depth": 0.0}
        gov.register("q.depth", lambda: v["depth"],
                     WatermarkPolicy(high=100.0, low=50.0,
                                     pressure=True))
        gov.sample_once(now=1.0)
        assert not gov.backpressure()
        v["depth"] = 150.0
        gov.sample_once(now=2.0)
        assert gov.backpressure()
        kinds = [e["kind"] for e in gov.events()]
        assert "watermark" in kinds and "backpressure" in kinds
        # hysteresis: between low and high stays engaged
        v["depth"] = 70.0
        gov.sample_once(now=3.0)
        assert gov.backpressure()
        v["depth"] = 10.0
        gov.sample_once(now=4.0)
        assert not gov.backpressure()
        assert [e for e in gov.events()
                if e.get("state") == "released"]

    def test_p99_reservoir(self):
        gov = Governor()
        for ms in range(100):
            gov.observe_eval_latency(ms / 1000.0)
        assert gov.p99_ms() == pytest.approx(99.0, abs=1.5)

    def test_status_shape(self):
        gov = Governor()
        gov.register("s.x", lambda: 1.0, WatermarkPolicy(high=5.0))
        gov.sample_once(now=0.0)
        st = gov.status()
        assert st["enabled"] and not st["backpressure"]
        names = [g["name"] for g in st["gauges"]]
        assert "s.x" in names
        g = st["gauges"][names.index("s.x")]
        assert g["high"] == 5.0 and g["status"] == "ok"


# -- eval broker: admission-controlled shed/requeue -------------------

@pytest.fixture
def broker():
    """An enabled EvalBroker, disabled at teardown: a broker left with a
    parked eval under a pressure gauge that never clears re-arms its
    admission timer (a new thread) every admission window for the rest
    of the process, and later tests that count threads see them."""
    b = EvalBroker()
    b.set_enabled(True)
    yield b
    b.set_enabled(False)


class TestBrokerBackpressure:
    def test_shed_defers_then_admits_on_clear(self, broker):
        b = broker
        b.admission_delay_s = 0.05
        pressured = {"on": True}
        b.pressure_fn = lambda: pressured["on"]
        ev = _eval()
        b.enqueue(ev)
        # shed onto the delayed (admission) path, not ready
        assert b.stats.total_ready == 0
        assert b.stats.total_waiting == 1
        assert b.stats.total_shed >= 1
        got, _ = b.dequeue(["service"], timeout_s=0.02)
        assert got is None
        # clear the gauge: the next admission window admits it
        pressured["on"] = False
        got, token = b.dequeue(["service"], timeout_s=2.0)
        assert got is not None and got.id == ev.id
        b.ack(ev.id, token)

    def test_shed_reparks_while_pressure_holds(self, broker):
        b = broker
        b.admission_delay_s = 0.02
        b.pressure_fn = lambda: True
        b.enqueue(_eval())
        time.sleep(0.15)        # several admission windows elapse
        assert b.stats.total_ready == 0
        assert b.stats.total_waiting == 1
        # the eval re-parked across those windows, but shed counts the
        # DECISION once — re-parks must not inflate it into a runaway
        # counter
        assert b.stats.total_shed == 1

    def test_delayed_core_eval_admits_under_pressure(self, broker):
        # a wait_until core eval (delayed GC follow-up) must admit on
        # schedule even while backpressure parks everything else
        from nomad_tpu_torch.models import JOB_TYPE_CORE
        b = broker
        b.admission_delay_s = 0.02
        b.pressure_fn = lambda: True
        b.enqueue(_eval())      # sheds
        b.enqueue(_eval(job_id="eval-gc", typ=JOB_TYPE_CORE,
                        wait_until=time.time() + 0.05))
        got, token = b.dequeue([JOB_TYPE_CORE], timeout_s=2.0)
        assert got is not None and got.type == JOB_TYPE_CORE
        b.ack(got.id, token)
        # the shed service eval is still parked
        assert b.stats.total_waiting == 1

    def test_core_evals_never_shed(self, broker):
        from nomad_tpu_torch.models import JOB_TYPE_CORE
        b = broker
        b.pressure_fn = lambda: True
        b.enqueue(_eval(job_id="eval-gc", typ=JOB_TYPE_CORE))
        got, token = b.dequeue([JOB_TYPE_CORE], timeout_s=1.0)
        assert got is not None
        b.ack(got.id, token)

    def test_no_pressure_fn_means_no_shed(self, broker):
        b = broker
        b.enqueue(_eval())
        assert b.stats.total_ready == 1
        assert b.stats.total_shed == 0


# -- event broker: byte-bounded history + truncation ------------------

class TestEventBrokerBounds:
    def _event(self, i, payload=None):
        return Event(topic="Job", type="T", key=f"k{i}", index=i,
                     payload=payload or {})

    def test_count_bound_still_applies(self):
        br = EventBroker(size=10)
        br.publish([self._event(i) for i in range(1, 26)])
        assert br.buffered_events() == 10
        assert br.trimmed_through == 15

    def test_byte_bound_trims_history(self):
        big = {"blob": "x" * 10_000}
        per = approx_event_bytes(self._event(1, dict(big)))
        br = EventBroker(size=10_000, max_bytes=per * 5)
        br.publish([self._event(i, dict(big)) for i in range(1, 21)])
        assert br.buffered_events() <= 5
        assert br.buffered_bytes() <= per * 5
        assert br.trimmed_through > 0

    def test_truncate_reclaim(self):
        br = EventBroker(size=1000)
        br.publish([self._event(i) for i in range(1, 101)])
        out = br.truncate(0.5)
        assert out["dropped_events"] == 50
        assert br.buffered_events() == 50
        # replay correctness: the gap is proven, not silent
        assert br.trimmed_through == 50
        st = br.stats()
        assert st["events"] == 50 and st["latest_index"] == 100

    def test_subscriber_replay_respects_trim(self):
        br = EventBroker(size=1000)
        br.publish([self._event(i) for i in range(1, 51)])
        br.truncate(0.5)
        _sub, backlog = br.subscribe(from_index=0)
        assert [e.index for e in backlog] == list(range(26, 51))


# -- state store: layer compaction ------------------------------------

class TestStoreCompaction:
    def test_version_debt_and_compact(self):
        from nomad_tpu_torch.mock import fixtures as mock
        store = StateStore()
        for i in range(50):
            n = mock.node()
            store.upsert_node(i + 100, n)
        debt = store.version_debt()
        assert debt > 0
        out = store.compact(min_tip=1)
        assert out["tables_folded"] >= 1
        assert out["overlay_reclaimed"] >= debt // 2
        assert store.version_debt() == 0
        # data intact after folding
        assert len(store.nodes()) == 50

    def test_compact_preserves_deletes(self):
        from nomad_tpu_torch.mock import fixtures as mock
        store = StateStore()
        nodes = []
        for i in range(20):
            n = mock.node()
            nodes.append(n)
            store.upsert_node(i + 100, n)
        store.delete_node(200, [n.id for n in nodes[:10]])
        store.compact(min_tip=1)
        assert len(store.nodes()) == 10
        assert store.node_by_id(nodes[0].id) is None
        assert store.node_by_id(nodes[15].id) is not None

    def test_old_snapshot_survives_compact(self):
        from nomad_tpu_torch.mock import fixtures as mock
        store = StateStore()
        n1 = mock.node()
        store.upsert_node(100, n1)
        snap = store.snapshot()
        n2 = mock.node()
        store.upsert_node(101, n2)
        store.compact(min_tip=0)
        # the pre-compact snapshot still reads its own version
        assert snap.node_by_id(n1.id) is not None
        assert len(store.nodes()) == 2

    def test_forced_compact_overrides_proportional_floor(self):
        # over-watermark escalation: force=True must fold overlays the
        # base/32 floor would veto, so the governor reclaim can never
        # latch into a permanent no-op while debt keeps growing
        from nomad_tpu_torch.mock import fixtures as mock
        store = StateStore()
        nodes = [mock.node() for _ in range(400)]
        for i, n in enumerate(nodes):
            store.upsert_node(i + 100, n)
        store.compact(min_tip=1)                 # base now large
        for i, n in enumerate(nodes[:8]):        # small fresh overlay
            n2 = mock.node()
            n2.id = n.id
            store.upsert_node(i + 600, n2)
        debt = store.version_debt()
        assert debt > 0
        # unforced: proportional floor (overlay*32 < base) vetoes
        assert store.compact(min_tip=1)["tables_folded"] == 0
        out = store.compact(min_tip=1, force=True)
        assert out["tables_folded"] >= 1
        assert out["overlay_reclaimed"] >= debt // 2
        assert store.version_debt() < debt

    def test_table_stats_shape(self):
        from nomad_tpu_torch.mock import fixtures as mock
        store = StateStore()
        store.upsert_node(100, mock.node())
        stats = store.table_stats()
        assert "nodes" in stats
        assert stats["nodes"]["size"] == 1
        assert "tip" in stats["nodes"]


# -- kernel cache bounds ----------------------------------------------

class TestKernelCacheGovernance:
    def test_stats_and_clear(self):
        from nomad_tpu_torch.ops.select import (KERNEL_CACHE_MAX,
                                          clear_kernel_caches,
                                          kernel_cache_entries,
                                          kernel_cache_stats)
        from nomad_tpu_torch.ops import kernels
        assert KERNEL_CACHE_MAX > 0
        # a memo entry, as a sharded launch's route query leaves one
        kernels._SCAN_INFO[(2, 8, 0)] = {"route": "cluster", "slots": 1,
                                         "max_clusters": 1}
        st = kernel_cache_stats()
        assert set(st) >= {"library", "max_shards", "scan_info",
                           "chunk_info", "chunk_plan"}
        total = kernel_cache_entries()
        assert total == sum(st.values())
        out = clear_kernel_caches()
        assert out["evicted"] == total - st["library"] >= 1
        assert kernel_cache_stats()["scan_info"] == 0


# -- server wiring + operator surface ---------------------------------

class TestGovernorServerWiring:
    @pytest.fixture()
    def server(self):
        from nomad_tpu_torch.server import ServerConfig
        s = Server(ServerConfig(num_schedulers=1,
                                governor_interval_s=0.1))
        s.start()
        yield s
        s.shutdown()

    def test_registered_structures(self, server):
        names = server.governor.registry.names()
        for expected in ("broker.ready", "plan_queue.depth",
                         "service.p99_ms", "event_broker.events",
                         "event_broker.bytes", "state.version_debt",
                         "kernel_cache.entries"):
            assert expected in names, expected
        assert server.eval_broker.pressure_fn is not None

    def test_metrics_carry_governor_gauges(self, server):
        server.governor.sample_once()
        from nomad_tpu_torch.utils import metrics
        gauges = {g["Name"] for g in metrics.snapshot()["Gauges"]}
        assert "nomad.governor.broker.ready" in gauges
        assert "nomad.governor.process.rss_mb" in gauges

    def test_http_and_cli_surface(self, server):
        from nomad_tpu_torch.api import ApiClient, HTTPApiServer
        api = HTTPApiServer(server, port=0)
        api.start()
        try:
            c = ApiClient(f"http://127.0.0.1:{api.port}")
            out = c.governor()
            assert out["enabled"]
            names = [g["name"] for g in out["gauges"]]
            assert "state.version_debt" in names
            # /v1/metrics carries the same accounting
            server.governor.sample_once()
            mnames = {g["Name"] for g in c.metrics()["Gauges"]}
            assert "nomad.governor.state.version_debt" in mnames

            # `operator governor` renders the table
            from nomad_tpu_torch.cli.main import main as cli_main
            rc = cli_main(["-address", f"http://127.0.0.1:{api.port}",
                           "operator", "governor"])
            assert rc == 0
        finally:
            api.shutdown()

    def test_worker_lane_shrink_under_pressure(self, server):
        w = server.workers[0]
        w.batch_size = 8
        assert w._effective_batch_size() == 8
        server.governor._bp.set()
        try:
            assert w._effective_batch_size() == 1
        finally:
            server.governor._bp.clear()
        assert w._effective_batch_size() == 8
