"""The reference's scenario matrix + fault injection suite
(tests/test_chaos.py) against the port's chaos/ on the CPU, assertions
unchanged: the six fault-injector tests (no server), the quick trio
(batch_backfill with a worker killed mid-commit, drain_storm with a WAL
tail corrupted before a reboot, blocked_herd) run once for the module
against real port Servers on the CPU and its five tests, the unknown
cell, and the two `slow` tests (the whole quick matrix, the
swim_partition cluster cell), kept `slow`.

Left out, waiting for the race sanitizer (analysis/):
test_quick_cells_race_clean_in_subprocess, which replays the trio
under NOMAD_TPU_RACE=1. The port's race report is always "off" (its
shims are not carried), which test_race_report_is_off_without_the_sanitizer
checks; test_cell_without_device_needs_cuda checks that a cell with no
device runs on the card or raises.
"""

import json
import os
import tempfile

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)
from nomad_tpu_torch.chaos import faults
from nomad_tpu_torch.chaos.matrix import (latest_artifact,
                                          run_cell as _run_cell,
                                          run_matrix as _run_matrix,
                                          write_artifact)
from nomad_tpu_torch.chaos.scenarios import SCENARIOS


def run_cell(scenario, seed=None, quick=True):
    """The port's run_cell on the CPU."""
    return _run_cell(scenario, seed=seed, quick=quick, device="cpu")


def run_matrix(names=None, quick=True, seed=None):
    """The port's run_matrix on the CPU."""
    return _run_matrix(names=names, quick=quick, seed=seed, device="cpu")


QUICK_TRIO = ("batch_backfill", "drain_storm", "blocked_herd")


# -- injector mechanics (no server) -----------------------------------

class TestFaultInjector:
    def test_install_is_exclusive_and_reversible(self):
        a, b = faults.FaultInjector(seed=1), faults.FaultInjector(seed=2)
        assert not faults.ACTIVE
        with a:
            assert faults.ACTIVE
            with pytest.raises(RuntimeError):
                b.install()
        assert not faults.ACTIVE
        # uninstalled injector no longer interposes
        assert faults.fire("server.heartbeat", node_id="x") is None

    def test_kill_on_commit_is_one_shot_and_counted(self):
        inj = faults.FaultInjector(seed=3)
        with inj:
            inj.kill_worker_on_commit(nth=2)
            assert faults.fire("worker.plan_committed",
                               eval_id="e1", placements=4) is None
            with pytest.raises(faults.WorkerKilled):
                faults.fire("worker.plan_committed",
                            eval_id="e2", placements=4)
            # one-shot: the redelivered eval's commit must survive
            assert faults.fire("worker.plan_committed",
                               eval_id="e2", placements=4) is None
        assert inj.killed_evals == ["e2"]
        kinds = [e["kind"] for e in inj.events]
        assert "worker_kill" in kinds

    def test_heartbeat_drop_respects_victim_set(self):
        inj = faults.FaultInjector(seed=4)
        with inj:
            inj.drop_heartbeats(["n1"])
            assert faults.fire("server.heartbeat", node_id="n1")
            assert not faults.fire("server.heartbeat", node_id="n2")
            inj.allow_heartbeats()
            assert not faults.fire("server.heartbeat", node_id="n1")
        assert inj.dropped_beats == 1

    def test_partition_interposes_probes_until_heal(self):
        inj = faults.FaultInjector(seed=5)
        with inj:
            inj.partition({"10.0.0.9:4647"})
            assert faults.fire("swim.probe", target="10.0.0.9:4647",
                               via="")
            assert faults.fire("swim.probe", target="10.0.0.9:4647",
                               via="relay")      # indirect cut too
            assert not faults.fire("swim.probe", target="10.0.0.2:4647",
                                   via="")
            inj.heal_partition()
            assert not faults.fire("swim.probe", target="10.0.0.9:4647",
                                   via="")

    def test_corrupt_wal_tail_flips_bytes(self):
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "raft.log")
            payload = bytes(range(256)) * 4
            with open(path, "wb") as f:
                f.write(payload)
            detail = faults.corrupt_wal_tail(d, span=64, seed=7)
            assert detail["corrupted_bytes"] == 64
            with open(path, "rb") as f:
                after = f.read()
            assert after[:-64] == payload[:-64]     # prefix untouched
            assert after[-64:] != payload[-64:]     # tail mangled
            # XOR with 1..255 is non-identity per byte
            assert all(a != b for a, b in
                       zip(after[-64:], payload[-64:]))

    def test_seeded_schedules_are_deterministic(self):
        drops = []
        for _ in range(2):
            inj = faults.FaultInjector(seed=11)
            with inj:
                inj.drop_heartbeats(None, prob=0.5)
                drops.append([bool(faults.fire("server.heartbeat",
                                               node_id=f"n{i}"))
                              for i in range(32)])
        assert drops[0] == drops[1]
        assert any(drops[0]) and not all(drops[0])


# -- the quick trio, in-process (the acceptance cells) ----------------

@pytest.fixture(scope="module")
def trio_results():
    """Run the three tier-1 cells ONCE and share the artifact
    sections across the assertions below."""
    return {name: run_cell(SCENARIOS[name], quick=True)
            for name in QUICK_TRIO}


def test_worker_kill_cell_no_double_commit(trio_results):
    cell = trio_results["batch_backfill"]
    assert cell["pass"], cell["invariants_failed"] or cell.get("error")
    assert cell["workers_killed"] == 1
    by_name = {c["name"]: c for c in cell["invariants"]}
    nd = by_name["no_plan_committed_twice"]
    assert nd["pass"] and nd["killed_evals"] == 1, nd
    assert not nd["duplicated"] and not nd["lost"], nd
    # the injected kill is in the recorded fault schedule
    assert any(e["kind"] == "worker_kill" for e in cell["faults"])
    assert by_name["no_lost_or_duplicated_alloc"]["pass"]


def test_wal_corruption_cell_recovers_to_intent(trio_results):
    cell = trio_results["drain_storm"]
    assert cell["pass"], cell["invariants_failed"] or cell.get("error")
    assert cell["wal_corrupted_bytes"] > 0
    # the reboot actually replayed a WAL (recovery stats captured)
    assert "recovery_restore_s" in cell
    by_name = {c["name"]: c for c in cell["invariants"]}
    assert by_name["no_lost_or_duplicated_alloc"]["pass"]
    assert by_name["drained_nodes_carry_no_live_allocs"]["pass"]
    assert by_name["recovered_after_corruption"]["pass"]
    assert any(e["kind"] == "wal_corruption" for e in cell["faults"])


def test_blocked_herd_cell_drains_exactly_once(trio_results):
    cell = trio_results["blocked_herd"]
    assert cell["pass"], cell["invariants_failed"] or cell.get("error")
    assert cell["herd_blocked_peak"] >= 6
    by_name = {c["name"]: c for c in cell["invariants"]}
    assert by_name["blocked_evals_drained"]["pass"]
    assert by_name["no_lost_or_duplicated_alloc"]["pass"]


def test_cell_artifact_section_shape(trio_results):
    """Every cell reports the contract the matrix promises: invariant
    verdicts, a flatness verdict, the fault schedule, workload
    numbers, and the race-finding count."""
    for name, cell in trio_results.items():
        assert cell["name"] == name
        assert isinstance(cell["seed"], int)
        assert cell["invariants"], name
        assert all("name" in c and "pass" in c
                   for c in cell["invariants"])
        assert "pass" in cell["flatness"], name
        assert cell["placements"] > 0, name
        assert cell["settle_p99_ms"] > 0, name
        race = [c for c in cell["invariants"]
                if c["name"] == "race_findings_zero"]
        assert len(race) == 1 and race[0]["race"] in ("on", "off")
        assert isinstance(cell["faults"], list)
        assert len(cell["windows"]) >= 2, name


# -- artifact files ----------------------------------------------------

def test_artifact_write_and_latest_roundtrip(trio_results):
    result = {"schema": "nomad-tpu/chaos/1", "quick": True,
              "race": "off",
              "cells": list(trio_results.values()),
              "summary": {"cells": len(trio_results)}}
    with tempfile.TemporaryDirectory() as d:
        assert latest_artifact(d) is None
        p1 = write_artifact(result, directory=d)
        assert os.path.basename(p1) == "CHAOS_r01.json"
        p2 = write_artifact(result, directory=d)
        assert os.path.basename(p2) == "CHAOS_r02.json"
        assert latest_artifact(d) == p2
        with open(p1) as f:
            loaded = json.load(f)
        assert loaded["schema"] == "nomad-tpu/chaos/1"
        assert {c["name"] for c in loaded["cells"]} == set(QUICK_TRIO)


def test_unknown_cell_name_is_an_error():
    with pytest.raises(KeyError):
        run_matrix(names=["no_such_cell"])


# -- the port's own -----------------------------------------------------

def test_race_report_is_off_without_the_sanitizer():
    """The race sanitizer (analysis/) is not carried: no baseline, and
    the per-cell check passes with race "off" and no findings."""
    from nomad_tpu_torch.chaos import invariants
    assert invariants.race_baseline() is None
    assert invariants.race_clean(None) == {
        "name": "race_findings_zero", "pass": True, "race": "off",
        "findings": 0}


def test_cell_records_where_its_live_allocs_sit(trio_results):
    """`placed`: each job's live allocs as sorted [alloc name, node id]
    pairs, read from the store before teardown. The trio's cells end
    with every placement live, each alloc name once, on a node the cell
    registered."""
    for name, cell in trio_results.items():
        placed = cell["placed"]
        pairs = [p for allocs in placed.values() for p in allocs]
        assert len(pairs) == cell["placements"], name
        assert len({a for a, _ in pairs}) == len(pairs), name
        assert all(allocs == sorted(allocs) for allocs in placed.values())
        for job, allocs in placed.items():
            assert all(a.startswith(job.split("/", 1)[1] + ".")
                       for a, _ in allocs), (name, job)
        assert all(n for _, n in pairs), name


def test_cell_without_device_needs_cuda():
    """run_cell with no device runs on the card: without one it raises
    before the cell starts, instead of running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        _run_cell(SCENARIOS["blocked_herd"])
    with pytest.raises(RuntimeError):
        _run_matrix(names=["blocked_herd"])
    assert not faults.ACTIVE


# -- the full matrix + cluster cell (slow) ----------------------------

@pytest.mark.slow
def test_full_quick_matrix_passes():
    result = run_matrix(quick=True)
    assert result["summary"]["cells"] >= 6
    assert result["summary"]["passed"] == result["summary"]["cells"], \
        result["summary"]


@pytest.mark.slow
def test_swim_partition_cell():
    cell = run_cell(SCENARIOS["swim_partition"], quick=True)
    assert cell["pass"], cell["invariants_failed"] or cell.get("error")
    by_name = {c["name"]: c for c in cell["invariants"]}
    assert by_name["partitioned_member_removed"]["pass"]
    assert by_name["quorum_writes_survive"]["pass"]
    assert by_name["victim_process_survived_partition"]["pass"]
