"""The reference's 1,000-seed micro-batch parity test
(tests/test_microbatch.py::test_randomized_microbatch_parity_1k_seeds)
against the port's MicroBatchGateway on SelectKernel("cpu"), its
assertions unchanged: concurrent lanes coalesced by the gateway place
exactly as the port's own solo select places each request. The port's
100-seed test against the JAX package's solo select is
tests/test_torch_gateway.py::test_concurrent_gateway_parity_100_seeds.

On the CPU the plain versions take about 0.13 s a seed, so the 1,000
seeds (over two minutes on one worker) are the `slow` case, and the
tier-1 case runs the first 100 of them.
"""

import threading
import time

import numpy as np
import pytest

from nomad_tpu_torch.ops.select import SelectKernel, SelectRequest
from nomad_tpu_torch.server.worker import MicroBatchGateway

import test_torch_select  # noqa: F401  (torch's thread cap)

CAP_ROW = np.array([[4000.0, 8192.0, 102400.0, 1000.0]], np.float32)


def _mk_req(capacity, count=4, ask=None, used=None, spreads=None,
            seed_used=None):
    n = capacity.shape[0]
    if used is None:
        used = np.zeros_like(capacity)
    return SelectRequest(
        ask=np.asarray(ask if ask is not None
                       else [100.0, 100.0, 10.0, 0.0], np.float32),
        count=count, feasible=np.ones(n, dtype=bool),
        capacity=capacity, used=used, desired_count=float(count),
        tg_collisions=np.zeros(n, np.int32),
        job_count=np.zeros(n, np.int32),
        spreads=spreads or [])


class ForceBatchKernel:
    """Wraps the port's CPU kernel but pins the profitability answer so
    the trigger logic under test is deterministic."""

    def __init__(self, profitable=True):
        self.inner = SelectKernel("cpu")
        self.profitable = profitable
        self.select_calls = 0
        self.select_many_calls = []

    def select(self, req):
        self.select_calls += 1
        return self.inner.select(req)

    def select_many(self, reqs):
        self.select_many_calls.append(len(reqs))
        return self.inner.select_many(reqs)

    def batch_dispatch_profitable(self, n, count_hint=16,
                                  tolerance=1.0):
        return self.profitable


def _streamingify(gw, gap=1e-5):
    """Force the arrival-rate model into 'streaming' so tests exercise
    the window instead of the idle fast path. `gap` also sets the
    straggler bound (STRAGGLER_GAPS * gap): tiny by default so lone
    leftovers fire fast; pass a larger gap to pin a waiter to the
    window."""
    gw._gap_ewma = gap
    gw._last_arrival = time.monotonic()



@pytest.mark.parametrize(
    "n_seeds", [100, pytest.param(1000, marks=pytest.mark.slow)])
def test_randomized_microbatch_parity_1k_seeds(n_seeds):
    """1000 random shared-table request groups dispatched CONCURRENTLY
    through the gateway place identically — node choices, final
    scores, per-component scores — to sequential per-eval select().
    Partitioning is off (it is a separately-tested throughput
    heuristic that deliberately perturbs winners); the coalescing
    mechanism itself must be placement-neutral."""
    n = 64
    kernel = ForceBatchKernel(profitable=True)
    base_cap = np.tile(CAP_ROW, (n, 1))
    ref = SelectKernel("cpu")
    for seed in range(n_seeds):
        rng = np.random.RandomState(seed)
        lanes = int(rng.randint(2, 5))
        capacity = base_cap * rng.uniform(0.8, 1.2)
        capacity = capacity.astype(np.float32)
        used = (capacity
                * rng.uniform(0.0, 0.4, size=capacity.shape)
                ).astype(np.float32)
        with_spread = seed % 4 == 0
        reqs, clones = [], []
        for i in range(lanes):
            if with_spread:
                count = 16
                codes = rng.randint(0, 4, size=n).astype(np.int32)
                spreads = [dict(codes=codes,
                                counts=np.zeros(5, np.float32),
                                present=np.zeros(5, bool),
                                desired=np.full(5, -1.0, np.float32),
                                weight=50.0, has_targets=False)]
            else:
                count = int(rng.randint(1, 33))
                spreads = None
            ask = np.array([float(rng.randint(50, 400)),
                            float(rng.randint(50, 400)),
                            10.0, 0.0], np.float32)
            for sink in (reqs, clones):
                sink.append(_mk_req(capacity, count=count, ask=ask,
                                    used=used.copy(), spreads=spreads))
        gw = MicroBatchGateway(kernel=kernel, window_us=5_000_000,
                               min_batch=lanes, partition=False)
        _streamingify(gw)
        outs = {}

        def lane(i, req):
            outs[i] = gw.dispatch(req)

        threads = [threading.Thread(target=lane, args=(i, r))
                   for i, r in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert sorted(outs) == list(range(lanes)), f"seed {seed}"
        for i, clone in enumerate(clones):
            want = ref.select(clone)
            got = outs[i]
            np.testing.assert_array_equal(
                got.node_idx, want.node_idx,
                err_msg=f"seed {seed} lane {i} node_idx")
            np.testing.assert_allclose(
                got.final_score, want.final_score, rtol=0, atol=0,
                err_msg=f"seed {seed} lane {i} final_score")
            for name, col in want.scores.items():
                np.testing.assert_allclose(
                    got.scores[name], col, rtol=0, atol=0,
                    err_msg=f"seed {seed} lane {i} {name}")
            assert got.placed == want.placed, f"seed {seed} lane {i}"
