"""Invariant checks for chaos cells.

Each check returns a plain dict — ``{"name", "pass", ...detail}`` —
that the matrix records verbatim in the cell's artifact section, so a
failed run carries the evidence, not just the verdict. The checks read
ONLY operator-visible state: the state store, ``Server.cluster_stats``
(the observability rollup), the governor event ring, and the race
monitor (not carried by this package yet: see race_clean). If an
invariant can't be judged from what an operator can see, the
observability plane is missing a signal — that's a finding too.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

from ..models import JOB_TYPE_SYSTEM


def check(name: str, passed: bool, **detail) -> dict:
    return {"name": name, "pass": bool(passed), **detail}


def _live_allocs(store, namespace: str, job_id: str) -> list:
    return [a for a in store.allocs_by_job(namespace, job_id)
            if not a.terminal_status()]


def alloc_intent(store, intent: Dict[Tuple[str, str], int],
                 name: str = "no_lost_or_duplicated_alloc") -> dict:
    """The workload's intent reconciles: for every job, each task-group
    slot name carries EXACTLY ONE non-terminal alloc — a missing name
    is a LOST alloc (a placement the workload asked for that nothing
    carries), a doubled name is a DUPLICATED one (the double-commit /
    double-reschedule class a worker kill or recovery replay would
    introduce)."""
    lost: List[str] = []
    dup: List[str] = []
    placed = 0
    for (ns, job_id), expected in intent.items():
        live = _live_allocs(store, ns, job_id)
        names = Counter(a.name for a in live)
        placed += len(live)
        dup.extend(f"{n} x{c}" for n, c in names.items() if c > 1)
        if len(names) < expected:
            lost.append(f"{job_id}: {len(names)}/{expected} names live")
        elif len(live) > expected and not dup:
            # same count of names but extra rows means duplicate names
            # already caught above; extra NAMES beyond intent is an
            # over-placement (count overrun)
            lost.append(f"{job_id}: {len(live)} live > {expected} asked")
    return check(name, not lost and not dup,
                 jobs=len(intent), live_allocs=placed,
                 lost=lost[:8], duplicated=dup[:8])


def system_fanout(store, job, expected_node_ids: Iterable[str]) -> dict:
    """SystemScheduler cross-check: exactly one live alloc of the
    system job on every expected (feasible, ready) node, zero
    elsewhere — the reference's scheduler/system.go contract."""
    expected = set(expected_node_ids)
    live = _live_allocs(store, job.namespace, job.id)
    by_node = Counter(a.node_id for a in live)
    missing = [n[:8] for n in expected if n not in by_node]
    doubled = [n[:8] for n, c in by_node.items() if c > 1]
    strays = [n[:8] for n in by_node if n not in expected]
    return check("system_fanout_covers_feasible_nodes",
                 not missing and not doubled and not strays,
                 expected_nodes=len(expected), live_allocs=len(live),
                 missing=missing[:8], doubled=doubled[:8],
                 strays=strays[:8])


def no_plan_committed_twice(store, intent, injector,
                            bound_s: Optional[float] = None) -> dict:
    """Across a worker kill: the killed eval's plan committed ONCE.
    Observable consequence — after the broker redelivers and the retry
    settles, the intent still holds with no duplicated name, AND every
    eval the injector killed reached a terminal status (the redelivery
    actually happened; a kill that silently wedges an eval forever is
    its own failure). Polls for the redelivery within the visibility
    bound — the nack path is delayed by design."""
    from .faults import DEFAULTS
    bound = DEFAULTS["visibility_bound_s"] if bound_s is None else bound_s

    def unsettled_now() -> List[str]:
        out = []
        for eid in injector.killed_evals:
            ev = store.eval_by_id(eid)
            if ev is None or ev.status not in ("complete", "failed",
                                               "canceled"):
                out.append(f"{eid[:8]}:"
                           f"{getattr(ev, 'status', 'missing')}")
        return out

    deadline = time.monotonic() + bound
    unsettled = unsettled_now()
    while unsettled and time.monotonic() < deadline:
        time.sleep(0.1)
        unsettled = unsettled_now()
    base = alloc_intent(store, intent, name="no_plan_committed_twice")
    base["killed_evals"] = len(injector.killed_evals)
    base["unsettled_killed_evals"] = unsettled
    base["pass"] = bool(base["pass"] and injector.killed_evals
                        and not unsettled)
    return base


def failure_visibility(server, expected_down: int,
                       bound_s: Optional[float] = None,
                       expected_stale: int = 0) -> dict:
    """The rollup reflects injected failures within the bound:
    `cluster.nodes_down` reaches the injected count (and
    `stale_heartbeats` the dropped-payload count) within
    faults.DEFAULTS["visibility_bound_s"] of the check starting. Polls — failure
    detection is asynchronous by design; the INVARIANT is the bound."""
    from .faults import DEFAULTS
    bound = DEFAULTS["visibility_bound_s"] if bound_s is None else bound_s
    t0 = time.monotonic()
    deadline = t0 + bound
    cs = server.cluster_stats()
    while time.monotonic() < deadline and (
            cs["nodes_down"] < expected_down
            or cs["stale_heartbeats"] < expected_stale):
        time.sleep(0.1)
        cs = server.cluster_stats()
    elapsed = time.monotonic() - t0
    ok = (cs["nodes_down"] >= expected_down
          and cs["stale_heartbeats"] >= expected_stale)
    return check("failure_visibility_within_bound", ok,
                 bound_s=bound, elapsed_s=round(elapsed, 2),
                 nodes_down=cs["nodes_down"],
                 expected_down=expected_down,
                 stale_heartbeats=cs["stale_heartbeats"],
                 expected_stale=expected_stale)


def used_vs_allocated(server, expect_divergence: bool,
                      min_allocated_ratio: float = 0.02,
                      used_floor_ratio: float = 0.5) -> dict:
    """Placement-without-execution detection (fleet economics): a
    scenario that 'places' allocs nothing runs shows the allocated
    ratio rising while host-truth used stays flat. Cells with real
    clients assert NO divergence (used tracks allocated); cells whose
    nodes are synthetic assert the signal FIRES — a detector that
    can't see its own scenario is broken."""
    cs = server.cluster_stats()
    alloc_r = max(cs["fleet_cpu_allocated_ratio"],
                  cs["fleet_mem_allocated_ratio"])
    used_r = max(cs["fleet_cpu_used_ratio"], cs["fleet_mem_used_ratio"])
    diverged = bool(alloc_r >= min_allocated_ratio
                    and used_r < alloc_r * used_floor_ratio)
    ok = diverged if expect_divergence else \
        bool(alloc_r < min_allocated_ratio or not diverged)
    return check("used_vs_allocated_divergence", ok,
                 expect_divergence=expect_divergence, diverged=diverged,
                 allocated_ratio=round(alloc_r, 4),
                 used_ratio=round(used_r, 4),
                 nodes_reporting=cs["nodes_reporting"])


def drained_nodes_empty(store, node_ids: Iterable[str]) -> dict:
    """After a drain storm settles, drained nodes carry no live
    allocs destined to run (migrating allocs moved or stopped)."""
    node_ids = list(node_ids)
    still = []
    for nid in node_ids:
        live = [a for a in store.allocs_by_node(nid)
                if not a.terminal_status()
                and not a.client_terminal_status()]
        if live:
            still.append(f"{nid[:8]}:{len(live)}")
    return check("drained_nodes_carry_no_live_allocs", not still,
                 drained=len(node_ids), still_occupied=still[:8])


def allocs_on_live_nodes(store, intent,
                         dead_node_ids: Iterable[str]) -> dict:
    """After a mass client failure reschedules, no live alloc of the
    intent jobs sits on a dead node (system jobs exempt — they are
    node-pinned and die with the node)."""
    dead = set(dead_node_ids)
    strayed = []
    for (ns, job_id) in intent:
        job = store.job_by_id(ns, job_id)
        if job is not None and job.type == JOB_TYPE_SYSTEM:
            continue
        for a in _live_allocs(store, ns, job_id):
            if a.node_id in dead:
                strayed.append(f"{a.name}@{a.node_id[:8]}")
    return check("no_live_alloc_on_dead_node", not strayed,
                 dead_nodes=len(dead), strayed=strayed[:8])


def per_node_saturation(store, intent, max_util: float = 0.85) -> dict:
    """Hot-spot bound under spread/anti-affinity topologies: the p99
    per-node allocated-cpu RATIO (the workload's allocs over the
    node's comparable capacity) stays under saturation — the
    scheduling-side analog of the per-node utilization p99 the
    rollup reports from host truth. Bin-packing concentrates by
    design; what spread must prevent is a saturated hot spot."""
    import numpy as np
    per_node: Dict[str, float] = {}
    total = 0
    for (ns, job_id) in intent:
        for a in _live_allocs(store, ns, job_id):
            cpu = sum(t.cpu.cpu_shares
                      for t in a.allocated_resources.tasks.values())
            per_node[a.node_id] = per_node.get(a.node_id, 0.0) + cpu
            total += 1
    nodes = store.nodes()
    if total == 0 or not nodes:
        return check("per_node_utilization_p99_bound", False,
                     reason="nothing placed")
    utils = []
    for n in nodes:
        cap = n.comparable_resources().cpu_shares
        utils.append(per_node.get(n.id, 0.0) / cap if cap > 0 else 0.0)
    p99 = float(np.percentile(np.asarray(utils), 99))
    return check("per_node_utilization_p99_bound", p99 <= max_util,
                 per_node_util_p99=round(p99, 4), bound=max_util,
                 hottest_util=round(max(utils), 4))


def spread_coverage(store, intent, attr_of_node,
                    min_distinct: int, attr: str = "attr") -> dict:
    """The spread/anti-affinity contract, per job: each job's live
    allocs cover at least `min_distinct` distinct values of the
    spread attribute (a job that doubles a rack while racks sit empty
    has lost its spread)."""
    thin = []
    for (ns, job_id) in intent:
        seen = set()
        for a in _live_allocs(store, ns, job_id):
            node = store.node_by_id(a.node_id)
            if node is not None:
                seen.add(attr_of_node(node))
        if len(seen) < min_distinct:
            thin.append(f"{job_id}: {len(seen)} {attr}s")
    return check(f"spread_coverage_{attr}", not thin,
                 min_distinct=min_distinct, thin=thin[:8])


def blocked_evals_drained(server) -> dict:
    """After the thundering herd unblocks, no eval is still parked in
    the blocked tracker and the broker holds no unacked backlog."""
    stats = server.blocked_evals.stats
    broker = server.eval_broker.stats.as_dict()
    blocked = stats.total_blocked + stats.total_escaped
    ok = blocked == 0 and broker["unacked"] == 0
    return check("blocked_evals_drained", ok,
                 blocked=stats.total_blocked,
                 escaped=stats.total_escaped,
                 broker_unacked=broker["unacked"])


# -- race sanitizer coupling -----------------------------------------
# The JAX package's copies read its runtime race sanitizer
# (nomad_tpu/analysis/race.py). This package does not carry analysis/
# yet, so its shims are always off: no baseline, and the per-cell check
# passes with race "off" and no findings, as the JAX package's does
# with its shims off.

def race_baseline() -> Optional[int]:
    """Unsuppressed finding count before the cell (None = shims off,
    always here)."""
    return None


def race_clean(baseline: Optional[int]) -> dict:
    """Zero new race findings during the cell. The shims are off in
    this package, so the check reports pass with race='off' and
    findings 0."""
    return check("race_findings_zero", True, race="off", findings=0)
