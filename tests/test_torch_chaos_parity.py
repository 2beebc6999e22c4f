"""The scenario matrix in both packages on the same seeds, on the CPU:
the JAX package's chaos/ (its servers on the CPU platform) against the
port's (its servers with device="cpu"). Tolerance: exact — every
compared value is equal.

- the injectors' seeded schedules: drop_heartbeats(prob=0.5) over 64
  nodes, seeds 1-3, drop for drop;
- corrupt_wal_tail leaves identical bytes;
- each of the nine cells derives the same seed, and from it the same
  nodes and jobs (ids, names, datacenters, racks, counts, resources);
- the quick trio (batch_backfill, drain_storm, blocked_herd) gives the
  same invariant names and verdicts, fault-event kinds, placement count
  and placement shape (every live alloc, the alloc count of each node),
  and in batch_backfill every live alloc on the same node. In
  drain_storm and blocked_herd thread timings (two scheduler workers,
  the drain timers) pick among equally good nodes, so their node ids
  vary from run to run in either package; so does how blocked_herd's
  last jobs share nodes in the JAX package.
"""

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)
from nomad_tpu.chaos import faults as ref_faults
from nomad_tpu.chaos import matrix as ref_matrix
from nomad_tpu.chaos import scenarios as ref_scenarios
from nomad_tpu_torch.chaos import faults as port_faults
from nomad_tpu_torch.chaos import matrix as port_matrix
from nomad_tpu_torch.chaos import scenarios as port_scenarios

QUICK_TRIO = ("batch_backfill", "drain_storm", "blocked_herd")
CELLS = list(ref_scenarios.SCENARIOS)


def _drops(faults, seed):
    inj = faults.FaultInjector(seed=seed)
    with inj:
        inj.drop_heartbeats(None, prob=0.5)
        return [bool(faults.fire("server.heartbeat", node_id=f"n{i}"))
                for i in range(64)]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_heartbeat_drop_schedules_are_equal(seed):
    ref = _drops(ref_faults, seed)
    assert _drops(port_faults, seed) == ref
    assert any(ref) and not all(ref)


@pytest.mark.parametrize("seed", [0, 7, 12633200])
def test_corrupt_wal_tail_leaves_identical_bytes(tmp_path, seed):
    payload = bytes(range(256)) * 8
    got = {}
    for name, faults in (("ref", ref_faults), ("port", port_faults)):
        d = tmp_path / name
        d.mkdir()
        (d / "raft.log").write_bytes(payload)
        detail = faults.corrupt_wal_tail(str(d), span=96, seed=seed)
        assert detail["corrupted_bytes"] == 96
        got[name] = (d / "raft.log").read_bytes()
    assert got["port"] == got["ref"]
    assert got["ref"][:-96] == payload[:-96]


def _derived_seed(matrix, scenarios, name, **kw):
    """The seed run_cell derives for a cell: the cell's scenario run with
    a body that does nothing."""
    sc = scenarios.SCENARIOS[name]
    noop = matrix.Scenario(name=sc.name, title=sc.title,
                           description=sc.description,
                           run=lambda cell: None, quick=sc.quick,
                           cluster=sc.cluster)
    return matrix.run_cell(noop, **kw)["seed"]


def _node_row(n):
    return (n.id, n.name, n.datacenter, n.meta.get("rack"),
            n.node_resources.cpu.cpu_shares,
            n.node_resources.memory.memory_mb, n.computed_class)


def _job_row(j):
    tg = j.task_groups[0]
    return (j.id, j.name, j.type, j.priority, tuple(j.datacenters),
            tg.count, tuple((t.name, t.resources.cpu, t.resources.memory_mb,
                             len(t.resources.networks)) for t in tg.tasks))


def _generated(matrix, scenarios, name, seed):
    """The workload generators every cell draws from, at the sizes the
    cells use."""
    cell = matrix.Cell(scenarios.SCENARIOS[name], seed, True)
    nodes = scenarios._mk_nodes(cell, 32, dcs=4, racks=8)
    nodes += scenarios._mk_nodes(cell, 24, dcs=1)
    nodes += scenarios._extra_nodes(cell, 2, 0x9E37, "dc2")
    nodes += scenarios._extra_nodes(cell, 2, 0x51ED, "dc2")
    jobs = [scenarios._svc_job(cell, f"{name}-svc", 8, priority=70,
                               cpu=600),
            scenarios._svc_job(cell, f"{name}-spread", 8, cpu=200,
                               mem=96, dcs=4),
            scenarios._svc_job(cell, f"{name}-batch", 8, priority=30,
                               cpu=300, job_type="batch"),
            scenarios._svc_job(cell, f"{name}-herd", 4, cpu=1200,
                               mem=512)]
    return [_node_row(n) for n in nodes], [_job_row(j) for j in jobs]


@pytest.mark.parametrize("name", CELLS)
def test_cells_derive_equal_seeds_nodes_and_jobs(name):
    ref_seed = _derived_seed(ref_matrix, ref_scenarios, name)
    port_seed = _derived_seed(port_matrix, port_scenarios, name,
                              device="cpu")
    assert port_seed == ref_seed
    ref_nodes, ref_jobs = _generated(ref_matrix, ref_scenarios, name,
                                     ref_seed)
    port_nodes, port_jobs = _generated(port_matrix, port_scenarios, name,
                                       port_seed)
    assert port_nodes == ref_nodes
    assert port_jobs == ref_jobs


# the trio's cells whose every live alloc lands on the same node run to run
EXACT_CELLS = ("batch_backfill",)


def _summary(cell, placed):
    out = {"invariants": [(c["name"], c["pass"])
                          for c in cell["invariants"]],
           "placements": cell["placements"],
           "shape": port_matrix.placement_shape(placed),
           "faults": [e["kind"] for e in cell["faults"]],
           "seed": cell["seed"], "pass": cell["pass"],
           "error": cell.get("error")}
    if cell["name"] in EXACT_CELLS:
        out["placed"] = placed
    return out


def _run_ref(name):
    """The JAX package's cell, with where its live allocs sit read from
    its servers' store just before its teardown (the port's run_cell
    returns that as `placed`)."""
    placed = {}
    teardown = ref_matrix.Cell.teardown

    def recording_teardown(cell):
        got = port_matrix.placed_allocs(cell._servers)
        if got:
            placed.update(got)
        teardown(cell)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_matrix.Cell, "teardown", recording_teardown)
        cell = ref_matrix.run_cell(ref_scenarios.SCENARIOS[name],
                                   quick=True)
    return _summary(cell, placed)


@pytest.fixture(scope="module")
def trio():
    """The quick trio through both packages, each cell once."""
    out = {}
    for name in QUICK_TRIO:
        port = port_matrix.run_cell(port_scenarios.SCENARIOS[name],
                                    quick=True, device="cpu")
        out[name] = (_run_ref(name), _summary(port, port["placed"]))
    return out


@pytest.mark.parametrize("name", QUICK_TRIO)
def test_quick_trio_equal_in_both_packages(trio, name):
    ref, port = trio[name]
    assert ref["pass"] and not ref["error"], ref
    assert ref["shape"]["allocs"], ref
    assert port == ref
