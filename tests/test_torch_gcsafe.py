"""The reference's GC safepoint tests (tests/test_gcsafe.py) against the
port's copy of utils/gcsafe.py, their assertions unchanged.
"""

import gc
import time
import weakref

import pytest

from nomad_tpu_torch.utils import gcsafe


class _Cyclic:
    def __init__(self):
        self.me = self


def test_enter_exit_restores_collector_state():
    was = gc.isenabled()
    gcsafe.enter()
    try:
        assert not gc.isenabled()
        gcsafe.enter()          # nested participant
        gcsafe.exit_()
        assert not gc.isenabled(), "still one participant registered"
    finally:
        gcsafe.exit_()
    assert gc.isenabled() == was


def test_full_collect_budget_reclaims_cycles(monkeypatch):
    """Cyclic garbage created under the regime is reclaimed once the
    gen-2 budget elapses — the unbounded-growth failure mode of the
    young-gen-only policy."""
    monkeypatch.setattr(gcsafe, "FULL_COLLECT_INTERVAL_S", 0.0)
    monkeypatch.setattr(gcsafe, "MIN_COLLECT_INTERVAL_S", 0.0)
    with gcsafe.safepoints():
        # age a cycle into gen-2 (two young collects promote it), then
        # orphan it; with only young-gen collects it would never die
        c = _Cyclic()
        ref = weakref.ref(c)
        gc.collect()
        gc.collect()
        del c
        gcsafe._last_collect = 0.0
        gcsafe._last_full_collect = 0.0
        gcsafe.safepoint()
        assert ref() is None, "gen-2 cycle survived the full-collect budget"


def test_soak_heap_stays_bounded(monkeypatch):
    """Mini-soak: churn cyclic garbage through repeated safepoints for
    a couple of seconds; tracked-object count must stay flat instead of
    growing with iterations."""
    monkeypatch.setattr(gcsafe, "FULL_COLLECT_INTERVAL_S", 0.2)
    monkeypatch.setattr(gcsafe, "MIN_COLLECT_INTERVAL_S", 0.0)
    with gcsafe.safepoints():
        gc.collect()
        baseline = len(gc.get_objects())
        deadline = time.time() + 2.0
        i = 0
        while time.time() < deadline:
            junk = [_Cyclic() for _ in range(200)]
            for j in junk:
                j.friend = junk      # bigger cycle through the list
            del junk
            gcsafe._last_collect = 0.0
            gcsafe.safepoint()
            i += 1
        gcsafe._last_collect = 0.0
        gcsafe._last_full_collect = 0.0
        gcsafe.safepoint()
        grown = len(gc.get_objects()) - baseline
    if i <= 10:
        # the loop is wall-clock-bound (2 s): on a loaded shared box
        # the iterations collapse and the flatness verdict means
        # nothing — skip instead of failing on scheduler starvation
        pytest.skip(f"box under load: soak loop ran only {i} "
                    f"iterations in its 2 s window")
    assert grown < 5000, f"tracked objects grew by {grown} over the soak"


def test_freeze_and_unfreeze_steady_state():
    substrate = [_Cyclic() for _ in range(100)]
    before = gc.get_freeze_count()
    gcsafe.freeze_steady_state()
    try:
        assert gc.get_freeze_count() > before
        # frozen objects are excluded from collection: a full collect
        # right after freezing is near-instant even with the substrate
        t0 = time.perf_counter()
        gc.collect()
        assert time.perf_counter() - t0 < 1.0
    finally:
        gcsafe.unfreeze_steady_state()
    assert gc.get_freeze_count() == 0
    assert substrate[0].me is substrate[0]
