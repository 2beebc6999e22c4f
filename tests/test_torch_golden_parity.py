"""Every scenario of the golden scheduler suites, through both packages.

Each test of tests/test_generic_golden.py and tests/test_system_golden.py
runs twice on the same seeded inputs: as the JAX package's test, and as
its port's copy (tests/test_torch_generic_golden.py,
tests/test_torch_system_golden.py) on the CPU, where the port's kernels
run their plain versions. Both runs draw every id (the mock fixtures', and
the evals' and allocs' the schedulers mint) from one seeded stream, so
both packages see the same nodes, jobs and evals in the same order. Every
Harness a scenario makes is recorded, and the pairs must agree: the
nodes and jobs by wire form (the inputs), and per alloc name the node it
landed on (id and name), its desired and client status, and its
AllocMetric scores within 1e-6; the evals' statuses and the plans'
placements by name.
"""

import importlib
import json
import os
import random

import numpy as np
import pytest

from nomad_tpu.utils.codec import to_wire as jax_to_wire
from nomad_tpu_torch.utils.codec import to_wire as port_to_wire

import test_torch_select  # noqa: F401  (torch's thread cap)

SUITES = {"generic": ("test_generic_golden", "test_torch_generic_golden"),
          "system": ("test_system_golden", "test_torch_system_golden")}
SEED = 20260417


def _scenarios():
    out = []
    for suite, (ref, _port) in SUITES.items():
        mod = importlib.import_module(ref)
        out += [(suite, name) for name in sorted(vars(mod))
                if name.startswith("test_") and callable(getattr(mod, name))]
    return out


def _canon(wire) -> str:
    return json.dumps(wire, sort_keys=True, default=str)


def _recording(cls, made):
    class Recording(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
    return Recording


def _run(monkeypatch, module_name, test_name, seed):
    """Run one golden test from `module_name` with every id drawn from a
    stream seeded by `seed`; returns the harnesses it made."""
    mod = importlib.import_module(module_name)
    made = []
    rng = random.Random(seed)
    with monkeypatch.context() as m:
        m.setattr(mod, "Harness", _recording(mod.Harness, made))
        m.setattr(os, "urandom", rng.randbytes)
        getattr(mod, test_name)()
    return made


def _placements(h, to_wire):
    """Per (job, alloc name): each alloc's node, statuses and scores, in
    creation order; plus the evals' statuses and the plans' placements."""
    store = h.store
    names = {n.id: n.name for n in store.nodes()}
    allocs = {}
    for a in sorted(store.allocs(), key=lambda a: (a.create_index, a.id)):
        m = a.metrics
        scores = [] if m is None else [
            (s.node_id, sorted(s.scores), [s.norm_score] +
             [s.scores[k] for k in sorted(s.scores)])
            for s in m.score_meta_data]
        allocs.setdefault((a.job_id, a.name), []).append(
            (a.node_id, names.get(a.node_id), a.desired_status,
             a.client_status, scores))
    plans = [sorted((a.name, a.node_id) for lst in p.node_allocation.values()
                    for a in lst) for p in h.plans]
    return dict(
        nodes=sorted(_canon(to_wire(n)) for n in store.nodes()),
        jobs=sorted(_canon(to_wire(j)) for j in store.jobs()),
        allocs=allocs,
        evals=[(e.id, e.status, e.status_description) for e in h.evals],
        created=[(e.id, e.status, e.triggered_by) for e in h.create_evals],
        plans=plans)


@pytest.mark.parametrize("suite,name", _scenarios(),
                         ids=[f"{s}-{n}" for s, n in _scenarios()])
def test_scenario_identical_in_both_packages(monkeypatch, suite, name):
    ref, port = SUITES[suite]
    jax_runs = _run(monkeypatch, ref, name, SEED)
    port_runs = _run(monkeypatch, port, name, SEED)
    assert len(port_runs) == len(jax_runs) >= 1
    for jh, th in zip(jax_runs, port_runs):
        assert th.device == "cpu"
        want = _placements(jh, jax_to_wire)
        got = _placements(th, port_to_wire)
        assert got["nodes"] == want["nodes"]
        assert got["jobs"] == want["jobs"]
        assert got["evals"] == want["evals"]
        assert got["created"] == want["created"]
        assert got["plans"] == want["plans"]
        assert got["allocs"].keys() == want["allocs"].keys()
        for key, rows in want["allocs"].items():
            mine = got["allocs"][key]
            assert [r[:4] for r in mine] == [r[:4] for r in rows], key
            for (*_t, ts), (*_j, js) in zip(mine, rows):
                assert [(n, k) for n, k, _v in ts] == \
                    [(n, k) for n, k, _v in js], key
                for (_n, _k, tv), (_n2, _k2, jv) in zip(ts, js):
                    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
