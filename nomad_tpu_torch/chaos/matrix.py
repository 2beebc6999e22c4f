"""The scenario-matrix core: Scenario cells, the Cell runtime each
scenario drives, and the runner that executes cells against a real
in-process Server (+simulated or real clients) on a device — the CUDA
card unless the caller passes "cpu" — and folds one artifact section
per cell.

A cell's artifact section carries, per the FoundationDB/Jepsen shape
the ROADMAP names: the seeded workload's throughput (placements/s,
p50/p99 of the workload's settle latencies), EVERY invariant verdict
with its evidence, a flatness verdict over the cell's windows (the
SAME `telemetry/flatness.flatness_verdict` math the live
/v1/operator/flatness route uses), the exact fault schedule the
injector delivered, and the race-finding count (always 0 with race
"off" here: this package does not carry the race sanitizer yet).

Entry points: `run_matrix` (the `nomad dev chaos` CLI), `run_cell`
(tests drive single cells), `write_artifact`/`latest_artifact`
(CHAOS_rNN.json; `nomad operator debug` bundles the latest one as
chaos.json).
"""

from __future__ import annotations

import json
import logging
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from . import faults, invariants

LOG = logging.getLogger("nomad_tpu.chaos")

ARTIFACT_PREFIX = "CHAOS_r"


@dataclass
class Scenario:
    """One matrix cell: a seeded workload generator + fault schedule +
    invariant checks + flatness verdict, all inside `run(cell)`."""
    name: str
    title: str
    description: str
    run: Callable[["Cell"], None]
    # safe for quick runs and tests (seconds, single process)
    quick: bool = True
    # needs a multi-server raft cluster (excluded from quick sets)
    cluster: bool = False
    tags: tuple = ()


class Cell:
    """The runtime a scenario drives: server lifecycle, the seeded
    injector, latency windows for the flatness verdict, and the
    invariant ledger. `device` is where the cell's servers run their
    kernels (None: the CUDA card)."""

    def __init__(self, scenario: Scenario, seed: int, quick: bool,
                 device=None):
        self.scenario = scenario
        self.device = device
        self.name = scenario.name
        self.seed = seed
        self.quick = quick
        self.injector = faults.FaultInjector(seed=seed)
        self.checks: List[dict] = []
        self.metrics: Dict[str, float] = {}
        self._servers: List = []
        self._lat: List[float] = []          # all settle latencies (s)
        self._windows: List[dict] = []
        self._win_lat: Optional[List[float]] = None
        self._t0 = time.perf_counter()
        self.placements = 0
        # where the cell's live allocs sit when it ends, by job
        self.placed: Dict[str, List[List[str]]] = {}

    # -- environment ---------------------------------------------------
    def server(self, start: bool = True, **cfg_kw):
        """Build + start a tracked Server. Chaos defaults: telemetry
        collector built but not free-running (cells call
        cluster_stats/sample_once at their own clock), governor on at
        a tight interval so watermark/backpressure machinery is live
        inside the cell. `start=False` for cluster cells that must
        attach raft before leadership. The server runs on the cell's
        device."""
        from ..server import Server, ServerConfig
        cfg_kw.setdefault("num_schedulers", 2)
        cfg_kw.setdefault("heartbeat_ttl_s", 30.0)
        cfg_kw.setdefault("telemetry_sample_interval_s", 3600.0)
        cfg_kw.setdefault("governor_interval_s", 0.2)
        srv = Server(ServerConfig(**cfg_kw), device=self.device)
        if start:
            srv.start()
        self._servers.append(srv)
        return srv

    def track(self, obj) -> None:
        """Track any object with .shutdown() for teardown (clients,
        rpc servers)."""
        self._servers.append(obj)

    def teardown(self) -> None:
        placed = placed_allocs(self._servers)
        if placed:
            self.placed = placed
        for obj in reversed(self._servers):
            try:
                obj.shutdown()
            except Exception:       # pragma: no cover — best effort
                LOG.exception("chaos cell %s: teardown failed",
                              self.name)
        self._servers.clear()

    def release(self, obj) -> None:
        """Stop tracking (the scenario shut it down itself — e.g. the
        rolling-restart cell's first server generation)."""
        if obj in self._servers:
            self._servers.remove(obj)

    # -- invariants ----------------------------------------------------
    def check(self, result: dict) -> dict:
        self.checks.append(result)
        return result

    # -- workload instrumentation --------------------------------------
    def note_latency(self, seconds: float, placements: int = 0) -> None:
        self._lat.append(seconds)
        self.placements += placements
        if self._win_lat is not None:
            self._win_lat.append(seconds)

    @contextmanager
    def window(self):
        """One flatness window: settle latencies noted inside fold to
        the window's p99, RSS sampled at close. Scenarios run their
        workload in waves, one wave per window."""
        from ..governor.governor import rss_mb
        self._win_lat = []
        w_t0 = time.perf_counter()
        try:
            yield
        finally:
            lats = self._win_lat or [0.0]
            self._win_lat = None
            self._windows.append({
                "t_min": (time.perf_counter() - self._t0) / 60.0,
                "dur_s": round(time.perf_counter() - w_t0, 3),
                "p99_ms": float(np.percentile(
                    np.asarray(lats), 99) * 1e3),
                "rss_mb": rss_mb(),
                "samples": len(lats),
            })

    def wait_for(self, pred, timeout_s: float = 20.0,
                 interval_s: float = 0.05) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if pred():
                return True
            time.sleep(interval_s)
        return False

    # -- verdict assembly ----------------------------------------------
    def flatness(self) -> dict:
        """The soak's verdict math over this cell's windows. Quick
        cells run seconds-long windows, where an RSS least-squares
        slope extrapolated to MB/HOUR is dominated by allocator noise
        (a live verdict once read -10161 MB/h on a healthy agent) — so
        quick mode widens the bounds and records that it
        did; the full matrix uses the soak's production bounds."""
        from ..telemetry.flatness import flatness_verdict
        if self.quick:
            # bound TOTAL growth, not the hourly extrapolation: allow
            # <=192 MB across the whole quick cell (JIT compiles +
            # bounded caches filling to plateau), expressed as the
            # equivalent slope over the cell's actual span so the
            # verdict's units match the soak's
            span_h = max((self._windows[-1]["t_min"]
                          - self._windows[0]["t_min"]) / 60.0, 1e-4)
            verdict = flatness_verdict(self._windows,
                                       max_p99_ratio=3.0,
                                       max_rss_slope=192.0 / span_h)
            verdict["quick_windows"] = True
            return verdict
        return flatness_verdict(self._windows)

    def result(self, error: Optional[str] = None) -> dict:
        elapsed = time.perf_counter() - self._t0
        lat = np.asarray(self._lat) if self._lat else np.zeros(1)
        inv_failed = [c["name"] for c in self.checks if not c["pass"]]
        flat = self.flatness() if self._windows else {
            "pass": None, "reason": "no windows"}
        out = {
            "name": self.name,
            "title": self.scenario.title,
            "seed": self.seed,
            "quick": self.quick,
            "elapsed_s": round(elapsed, 2),
            "placements": self.placements,
            "placements_per_sec": round(self.placements / elapsed, 1)
            if elapsed > 0 else 0.0,
            "settle_p50_ms": round(float(np.percentile(lat, 50)) * 1e3,
                                   2),
            "settle_p99_ms": round(float(np.percentile(lat, 99)) * 1e3,
                                   2),
            "invariants": self.checks,
            "invariants_failed": inv_failed,
            "flatness": flat,
            "faults": self.injector.events,
            "placed": self.placed,
            "windows": self._windows,
            **self.metrics,
        }
        if error:
            out["error"] = error
        # the cell verdict: every invariant held and the run completed.
        # Flatness is reported but gates only the FULL matrix (quick
        # windows are too short to indict a leak)
        out["pass"] = bool(not error and not inv_failed
                           and (self.quick or flat.get("pass")
                                is not False))
        return out


def placed_allocs(objs) -> Dict[str, List[List[str]]]:
    """Each job's live allocs as sorted [alloc name, node id] pairs, read
    from the store of the servers among `objs` that are still up: the
    raft leader's where there is one, else the last one built."""
    servers = [o for o in objs if getattr(o, "store", None) is not None
               and not getattr(o, "_shutdown", False)]
    if not servers:
        return {}
    leaders = [s for s in servers if getattr(s, "raft", None) is not None
               and s.raft.is_leader()]
    store = (leaders or servers)[-1].store
    placed: Dict[str, List[List[str]]] = {}
    for a in store.allocs():
        if not a.terminal_status():
            placed.setdefault(f"{a.namespace}/{a.job_id}", []).append(
                [a.name, a.node_id])
    return {k: sorted(v) for k, v in sorted(placed.items())}


def placement_shape(placed: Dict[str, List[List[str]]]) -> dict:
    """Where a cell's live allocs sit, without the node ids: every alloc
    name and the sorted alloc count of each node used. Where thread
    timings pick among equally good nodes, runs agree in this and not in
    the ids."""
    from collections import Counter
    per_node = Counter(n for allocs in placed.values() for _, n in allocs)
    return {"allocs": sorted(a for allocs in placed.values()
                             for a, _ in allocs),
            "per_node": sorted(per_node.values())}


def run_cell(scenario: Scenario, seed: Optional[int] = None,
             quick: bool = True, device=None) -> dict:
    """Execute one cell: install the seeded injector, run the scenario
    against real servers on `device` (None: the CUDA card), always
    record the race-finding delta, tear everything down, and return the
    artifact section. A missing card raises here, before the cell
    starts: nothing quietly runs on the CPU."""
    from ..ops.select import resolve_device
    device = resolve_device(device)
    if seed is None:
        import zlib
        base = faults.DEFAULTS["seed"]
        # derive a stable per-cell seed so every cell differs but the
        # matrix is reproducible from one number (crc32, NOT hash():
        # str hashing is salted per process)
        seed = (base or 0xC0FFEE) ^ \
            (zlib.crc32(scenario.name.encode()) & 0xFFFF)
    cell = Cell(scenario, seed, quick, device=device)
    race_base = invariants.race_baseline()
    error = None
    cell.injector.install()
    try:
        scenario.run(cell)
    except Exception as e:          # a crashed cell is a FAILED cell,
        LOG.exception("chaos cell %s crashed", scenario.name)
        error = f"{type(e).__name__}: {e}"   # not a crashed matrix
    finally:
        cell.injector.uninstall()
        cell.teardown()
    cell.check(invariants.race_clean(race_base))
    return cell.result(error)


def run_matrix(names: Optional[List[str]] = None, quick: bool = True,
               seed: Optional[int] = None, device=None) -> dict:
    """Run the named cells (default: every quick cell when quick, the
    whole single-process matrix otherwise) on `device` (None: the CUDA
    card) and fold the artifact."""
    from .scenarios import SCENARIOS
    selected: List[Scenario] = []
    if names:
        unknown = [n for n in names if n not in SCENARIOS]
        if unknown:
            raise KeyError(
                f"unknown chaos cells {unknown}; have "
                f"{sorted(SCENARIOS)}")
        selected = [SCENARIOS[n] for n in names]
    else:
        selected = [s for s in SCENARIOS.values()
                    if (s.quick or not quick) and not s.cluster]
    cells = []
    for sc in selected:
        LOG.info("chaos: running cell %s", sc.name)
        cells.append(run_cell(sc, seed=seed, quick=quick, device=device))
    passed = [c for c in cells if c["pass"]]
    return {
        "schema": "nomad-tpu/chaos/1",
        "quick": quick,
        "race": "off",
        "cells": cells,
        "summary": {
            "cells": len(cells),
            "passed": len(passed),
            "failed": [c["name"] for c in cells if not c["pass"]],
            "invariants_checked": sum(len(c["invariants"])
                                      for c in cells),
            "invariants_failed": sum(len(c["invariants_failed"])
                                     for c in cells),
            "race_findings": sum(
                c0.get("findings", 0) for c in cells
                for c0 in c["invariants"]
                if c0["name"] == "race_findings_zero"),
        },
    }


# -- artifact files ---------------------------------------------------

def next_artifact_path(directory: str = ".") -> str:
    """First free CHAOS_rNN.json in `directory` (r01, r02, ...)."""
    n = 1
    while True:
        path = os.path.join(directory, f"{ARTIFACT_PREFIX}{n:02d}.json")
        if not os.path.exists(path):
            return path
        n += 1


def latest_artifact(directory: str = ".") -> Optional[str]:
    """Newest CHAOS_rNN.json in `directory`, or None. `nomad operator
    debug` bundles it as chaos.json."""
    def run_no(name: str) -> int:
        try:
            return int(name[len(ARTIFACT_PREFIX):-len(".json")])
        except ValueError:
            return -1
    try:
        names = sorted((f for f in os.listdir(directory)
                        if f.startswith(ARTIFACT_PREFIX)
                        and f.endswith(".json")),
                       key=run_no)   # numeric: r100 sorts after r99
    except OSError:
        return None
    return os.path.join(directory, names[-1]) if names else None


def write_artifact(result: dict, path: Optional[str] = None,
                   directory: str = ".") -> str:
    path = path or next_artifact_path(directory)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f, indent=1, default=str, sort_keys=False)
        f.write("\n")
    os.replace(tmp, path)
    return path
