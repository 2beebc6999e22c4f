"""Client-side workload observability: host + per-alloc resource
usage.

The executor/docker drivers have always COLLECTED resource usage
(cgroup stats(), Engine API stats) — it just never left the client
process. This module closes that gap with the reference's shape:

- `HostStatsCollector` samples cpu/memory/disk/uptime from `/proc`
  (no new deps — the psutil-free analog of client/stats/host.go via
  gopsutil) plus every running task's driver `stats()` hook, and
  retains both in a bounded struct-of-arrays ring (`StatsRing`, the
  ring of the JAX package's telemetry collector): one float64 column
  per series, slot cursor, wrap-around, series absent in a sample
  record NaN — so a dead alloc's series reads None, never a stale
  wrapped-over value, and alloc churn is hard-bounded by MAX_SERIES
  with drops counted.
- `host_stats()` / `alloc_stats()` return the reference's HostStats /
  AllocResourceUsage wire shapes (client/structs/structs.go), served
  over the client RPC listener (`ClientStats.*`) behind
  `/v1/client/stats` and `/v1/client/allocation/<id>/stats`.
- `summary()` is the compact payload heartbeats carry north so the
  server can fold fleet-wide used-vs-allocated economics without a
  per-node scrape fan-out (`Server.cluster_stats`).

Off arm: `ClientConfig(stats_sample_interval_s=0)` builds no collector
at all — heartbeats carry no stats payload and the stats routes report
the node dark. No environment variable switches it.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils import metrics
from ..utils.locks import make_lock

DEFAULT_INTERVAL_S = 1.0
DEFAULT_SLOTS = 128

# hard series ceiling: alloc churn must not grow the ring without
# bound — excess series are dropped and counted in status()
MAX_SERIES = 256


def rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


class StatsRing:
    """Struct-of-arrays history ring: one float64 column per series, a
    write cursor, wrap-around overwrite. Each sample records the
    process RSS, the registry's counter totals and `gauges_fn()`;
    `sample_once()` is the deterministic entry the thread loop and the
    tests share."""

    RATE_PREFIXES = ("counter.",)

    def __init__(self, interval_s: float = DEFAULT_INTERVAL_S,
                 slots: int = DEFAULT_SLOTS,
                 gauges_fn: Optional[Callable[[], Dict[str, float]]]
                 = None):
        self.interval_s = max(float(interval_s), 0.05)
        self.slots = max(int(slots), 8)
        self.gauges_fn = gauges_fn
        self._l = make_lock()
        self._t = np.full(self.slots, np.nan, dtype=np.float64)
        self._series: Dict[str, np.ndarray] = {}
        self._n = 0                     # total samples ever written
        self._dropped_series = 0
        self._started_at = time.time()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="client-stats")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:       # pragma: no cover — defensive
                logging.getLogger("nomad_tpu.client.stats").exception(
                    "client stats sample failed")

    def _collect_row(self) -> Dict[str, float]:
        row: Dict[str, float] = {"process.rss_mb": rss_mb()}
        if self.gauges_fn is not None:
            try:
                row.update(self.gauges_fn())
            except Exception:       # pragma: no cover — defensive
                pass
        for name, total in metrics.counter_totals().items():
            row[f"counter.{name}"] = total
        return row

    def sample_once(self, now: Optional[float] = None) -> int:
        """Collect one row into the ring; returns the sample ordinal.
        Series first seen mid-run begin at this slot (earlier slots
        hold NaN); series absent this sample record NaN so a
        wrapped-over stale value can never masquerade as fresh."""
        row = self._collect_row()
        now = time.time() if now is None else now
        with self._l:
            cur = self._n % self.slots
            self._t[cur] = now
            for arr in self._series.values():
                arr[cur] = np.nan
            for name, value in row.items():
                arr = self._series.get(name)
                if arr is None:
                    if len(self._series) >= MAX_SERIES:
                        self._dropped_series += 1
                        continue
                    arr = self._series[name] = np.full(
                        self.slots, np.nan, dtype=np.float64)
                try:
                    arr[cur] = float(value)
                except (TypeError, ValueError):
                    arr[cur] = np.nan
            self._n += 1
            return self._n

    def _order(self) -> np.ndarray:
        """Chronological slot indexes of the valid window."""
        if self._n <= self.slots:
            return np.arange(self._n)
        cur = self._n % self.slots
        return np.concatenate([np.arange(cur, self.slots),
                               np.arange(0, cur)])

    def history(self, last: Optional[int] = None) -> dict:
        """The ring, chronological, JSON-safe (NaN -> None). `last`
        limits to the most recent N samples."""
        with self._l:
            order = self._order()
            if last is not None and last > 0:
                order = order[-last:]
            t = self._t[order]
            series = {name: arr[order].tolist()
                      for name, arr in sorted(self._series.items())}

        def clean(vals):
            return [None if (isinstance(v, float) and math.isnan(v))
                    else v for v in vals]
        return {
            "interval_s": self.interval_s,
            "slots": self.slots,
            "samples": self._n,
            "series_count": len(series),
            "series_dropped": self._dropped_series,
            "t": t.tolist(),
            "series": {k: clean(v) for k, v in series.items()},
            "rates": {k: clean(self._rate(t, np.asarray(v, np.float64)))
                      for k, v in series.items()
                      if k.startswith(self.RATE_PREFIXES)},
        }

    @staticmethod
    def _rate(t: np.ndarray, totals: np.ndarray) -> List[float]:
        """Per-second rates from a cumulative series (first slot NaN;
        a counter reset reads NaN, not a negative rate)."""
        out = np.full(len(totals), np.nan)
        if len(totals) >= 2:
            dt = np.diff(t)
            dv = np.diff(totals)
            with np.errstate(invalid="ignore", divide="ignore"):
                r = np.where((dt > 0) & (dv >= 0), dv / np.maximum(
                    dt, 1e-9), np.nan)
            out[1:] = r
        return [float(v) for v in out]

    def status(self) -> dict:
        with self._l:
            nbytes = self._t.nbytes + sum(
                a.nbytes for a in self._series.values())
            return {
                "enabled": True,
                "running": self._thread is not None,
                "interval_s": self.interval_s,
                "slots": self.slots,
                "samples": self._n,
                "series_count": len(self._series),
                "series_dropped": self._dropped_series,
                "ring_bytes": int(nbytes),
                "started_at": self._started_at,
            }


def read_proc_cpu() -> Optional[Tuple[float, float]]:
    """(total_ticks, idle_ticks) from the aggregate /proc/stat cpu
    line; None where /proc isn't mounted (non-Linux dev hosts)."""
    try:
        with open("/proc/stat") as f:
            line = f.readline()
    except OSError:
        return None
    parts = line.split()
    if not parts or parts[0] != "cpu":
        return None
    ticks = [float(x) for x in parts[1:]]
    if len(ticks) < 4:
        return None
    # idle + iowait both count as idle (host.go CPUStats)
    idle = ticks[3] + (ticks[4] if len(ticks) > 4 else 0.0)
    return sum(ticks), idle


def read_proc_meminfo() -> Dict[str, float]:
    """{total_mb, available_mb, free_mb} from /proc/meminfo; empty
    where unavailable."""
    out: Dict[str, float] = {}
    want = {"MemTotal": "total_mb", "MemAvailable": "available_mb",
            "MemFree": "free_mb"}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                key = line.split(":", 1)[0]
                name = want.get(key)
                if name is None:
                    continue
                out[name] = float(line.split()[1]) / 1024.0  # kB -> MB
                if len(out) == len(want):
                    break
    except OSError:
        return {}
    return out


def read_uptime_s() -> float:
    try:
        with open("/proc/uptime") as f:
            return float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0


def read_disk_mb(path: str) -> Tuple[float, float]:
    """(used_mb, total_mb) of the filesystem holding `path`."""
    try:
        st = os.statvfs(path or "/")
    except OSError:
        return 0.0, 0.0
    total = st.f_blocks * st.f_frsize / (1024.0 * 1024.0)
    free = st.f_bavail * st.f_frsize / (1024.0 * 1024.0)
    return max(total - free, 0.0), total


class HostStatsCollector:
    """Samples host + per-alloc usage into a retained ring. One
    instance per client agent; `sample_once()` is the deterministic
    entry the thread loop and the tests share (the Governor /
    TelemetryCollector idiom)."""

    def __init__(self, client=None, interval_s: float = DEFAULT_INTERVAL_S,
                 slots: int = DEFAULT_SLOTS, alloc_dir: str = ""):
        self.client = client
        self.alloc_dir = alloc_dir or "/"
        self.ring = StatsRing(interval_s=interval_s, slots=slots,
                              gauges_fn=self._collect)
        self._l = make_lock()
        # _collect publishes these by rebinding under _l, and heartbeat
        # and summary read them under _l: a published snapshot is never
        # mutated in place
        self._latest_host: Dict = {}
        self._latest_allocs: Dict[str, Dict] = {}
        # previous-sample anchors for percent derivations
        self._prev_cpu: Optional[Tuple[float, float]] = None
        self._prev_task_ns: Dict[Tuple[str, str], Tuple[float, float]] = {}

    # -- lifecycle (delegated to the ring's thread) --------------------
    def start(self) -> None:
        self.ring.start()

    def stop(self) -> None:
        self.ring.stop()

    def sample_once(self, now: Optional[float] = None) -> int:
        return self.ring.sample_once(now=now)

    # -- the sampling step ---------------------------------------------
    def _host_row(self, now: float) -> Dict[str, float]:
        row: Dict[str, float] = {}
        cpu = read_proc_cpu()
        cpu_pct = 0.0
        if cpu is not None:
            prev = self._prev_cpu
            self._prev_cpu = cpu
            if prev is not None:
                dt_total = cpu[0] - prev[0]
                dt_idle = cpu[1] - prev[1]
                if dt_total > 0:
                    cpu_pct = max(0.0, min(
                        100.0, 100.0 * (1.0 - dt_idle / dt_total)))
            row["host.cpu_total_ticks"] = cpu[0]
        row["host.cpu_pct"] = cpu_pct
        mem = read_proc_meminfo()
        if mem:
            row["host.mem_total_mb"] = mem.get("total_mb", 0.0)
            row["host.mem_available_mb"] = mem.get("available_mb", 0.0)
            row["host.mem_used_mb"] = max(
                mem.get("total_mb", 0.0) - mem.get("available_mb", 0.0),
                0.0)
        disk_used, disk_total = read_disk_mb(self.alloc_dir)
        row["host.disk_used_mb"] = disk_used
        row["host.disk_total_mb"] = disk_total
        row["host.uptime_s"] = read_uptime_s()
        try:
            row["host.load1"] = os.getloadavg()[0]
        except (OSError, AttributeError):
            pass
        return row

    def _alloc_rows(self, now: float) -> Tuple[Dict[str, float], Dict]:
        """Poll every live task's driver stats() (pull model — no
        per-task poll threads); derive cpu percent from cumulative
        ns deltas between our own samples. Returns (ring row, latest
        per-alloc AllocResourceUsage snapshots)."""
        row: Dict[str, float] = {}
        latest: Dict[str, Dict] = {}
        runners = dict(getattr(self.client, "runners", None) or {})
        live: set = set()
        for alloc_id, runner in runners.items():
            tasks: Dict[str, Dict] = {}
            for tr in getattr(runner, "task_runners", []):
                live.add((alloc_id, tr.task.name))
                handle = tr.handle
                stats_fn = getattr(tr.driver, "stats", None)
                if handle is None or stats_fn is None or handle.done():
                    continue
                try:
                    raw = stats_fn(handle) or {}
                except Exception:
                    continue
                if not raw:
                    continue
                rss = float(raw.get("memory_bytes", 0.0))
                cpu_ns = float(raw.get("cpu_total_ns", 0.0))
                key = (alloc_id, tr.task.name)
                prev = self._prev_task_ns.get(key)
                self._prev_task_ns[key] = (cpu_ns, now)
                cpu_pct = 0.0
                if prev is not None and now > prev[1] and \
                        cpu_ns >= prev[0]:
                    cpu_pct = (cpu_ns - prev[0]) / 1e9 \
                        / (now - prev[1]) * 100.0
                tasks[tr.task.name] = {
                    "ResourceUsage": {
                        "MemoryStats": {"RSS": int(rss)},
                        "CpuStats": {"TotalTicks": cpu_ns / 1e6,
                                     "Percent": round(cpu_pct, 3)},
                    },
                    "Timestamp": int(now * 1e9),
                }
                short = alloc_id[:8]
                row[f"alloc.{short}.{tr.task.name}.rss_mb"] = \
                    rss / (1024.0 * 1024.0)
                row[f"alloc.{short}.{tr.task.name}.cpu_pct"] = cpu_pct
                # keep the legacy per-task poll's registry family
                # alive (nomad.client.allocs.*): same values, one
                # reader — the poll thread this pull superseded
                prefix = f"nomad.client.allocs.{short}.{tr.task.name}"
                for k, v in raw.items():
                    metrics.set_gauge(f"{prefix}.{k}", float(v))
            if tasks:
                rss_sum = sum(t["ResourceUsage"]["MemoryStats"]["RSS"]
                              for t in tasks.values())
                pct_sum = sum(t["ResourceUsage"]["CpuStats"]["Percent"]
                              for t in tasks.values())
                ticks = sum(t["ResourceUsage"]["CpuStats"]["TotalTicks"]
                            for t in tasks.values())
                latest[alloc_id] = {
                    "ResourceUsage": {
                        "MemoryStats": {"RSS": int(rss_sum)},
                        "CpuStats": {"TotalTicks": ticks,
                                     "Percent": round(pct_sum, 3)},
                    },
                    "Tasks": tasks,
                    "Timestamp": int(now * 1e9),
                }
        row["host.allocs_running"] = float(len(runners))
        # drop anchors only for tasks that left the NODE (not tasks
        # that merely skipped one sample on a transient read failure —
        # resetting those would fake a cpu dip), so the dict can't
        # grow with alloc churn
        for key in list(self._prev_task_ns):
            if key not in live:
                del self._prev_task_ns[key]
        return row, latest, set(runners)

    def _collect(self) -> Dict[str, float]:
        """The ring's gauges_fn: one full host + alloc sample,
        published atomically (host_stats/summary readers never see a
        half-updated sample). Host gauges mirror into the process
        metrics registry so `/v1/metrics?format=prometheus` exposes
        the host-stats family (in the dev agent the client shares the
        server's registry)."""
        now = time.time()
        row = self._host_row(now)
        alloc_row, latest, runner_ids = self._alloc_rows(now)
        row.update(alloc_row)
        with self._l:
            # an alloc still ON the node whose only task transiently
            # failed its stats read keeps its last-known snapshot (the
            # Timestamp shows its age) — only allocs that LEFT drop,
            # matching the cpu-anchor transient-miss stance above
            for aid, prev in self._latest_allocs.items():
                if aid in runner_ids and aid not in latest:
                    latest[aid] = prev
            self._latest_host = {"ts": now, **row}
            self._latest_allocs = latest
        for k in ("host.cpu_pct", "host.mem_used_mb",
                  "host.disk_used_mb", "host.allocs_running"):
            if k in row:
                metrics.set_gauge(f"nomad.client.{k}", row[k])
        return row

    # -- reads (the RPC/HTTP surface) ----------------------------------
    def host_stats(self) -> Dict:
        """Latest sample in the reference HostStats wire shape
        (command/agent/stats_endpoint.go serves client.StatsReporter's
        LatestHostStats)."""
        with self._l:
            h = dict(self._latest_host)
            n_allocs = len(self._latest_allocs)
        return {
            "Timestamp": int(h.get("ts", 0.0) * 1e9),
            "CPU": [{"CPU": "cpu-total",
                     "TotalPercent": h.get("host.cpu_pct", 0.0)}],
            "CPUTicksConsumed": h.get("host.cpu_total_ticks", 0.0),
            "Memory": {
                "Total": int(h.get("host.mem_total_mb", 0.0) * 1024
                             * 1024),
                "Available": int(h.get("host.mem_available_mb", 0.0)
                                 * 1024 * 1024),
                "Used": int(h.get("host.mem_used_mb", 0.0) * 1024
                            * 1024),
            },
            "DiskStats": [{
                "Device": "alloc_dir", "Mountpoint": self.alloc_dir,
                "Size": int(h.get("host.disk_total_mb", 0.0) * 1024
                            * 1024),
                "Used": int(h.get("host.disk_used_mb", 0.0) * 1024
                            * 1024),
                "UsedPercent": round(
                    100.0 * h.get("host.disk_used_mb", 0.0)
                    / max(h.get("host.disk_total_mb", 0.0), 1e-9), 2),
            }],
            "Uptime": h.get("host.uptime_s", 0.0),
            # running = alloc runners on this node; reporting = those
            # whose tasks returned driver stats this sample (drivers
            # without a stats() hook run without reporting)
            "AllocsRunning": int(h.get("host.allocs_running", 0.0)),
            "AllocsReporting": n_allocs,
            "ring": self.ring.status(),
        }

    def alloc_stats(self, alloc_id: str) -> Optional[Dict]:
        """Latest AllocResourceUsage for one alloc (full id or unique
        prefix), or None when the alloc isn't reporting here."""
        with self._l:
            hit = self._latest_allocs.get(alloc_id)
            if hit is None:
                pref = [a for a in self._latest_allocs
                        if a.startswith(alloc_id)]
                hit = (self._latest_allocs[pref[0]]
                       if len(pref) == 1 else None)
            return dict(hit) if hit is not None else None

    def summary(self) -> Dict[str, float]:
        """The compact host-stats payload heartbeats carry: what the
        server's cluster rollup needs, ~8 floats, nothing per-alloc."""
        with self._l:
            h = dict(self._latest_host)
        if not h:
            return {}
        return {
            "ts": h.get("ts", 0.0),
            "cpu_pct": round(h.get("host.cpu_pct", 0.0), 3),
            "mem_used_mb": round(h.get("host.mem_used_mb", 0.0), 1),
            "mem_total_mb": round(h.get("host.mem_total_mb", 0.0), 1),
            "disk_used_mb": round(h.get("host.disk_used_mb", 0.0), 1),
            "disk_total_mb": round(h.get("host.disk_total_mb", 0.0), 1),
            "uptime_s": round(h.get("host.uptime_s", 0.0), 1),
            "allocs": h.get("host.allocs_running", 0.0),
        }

    def history(self, last: Optional[int] = None) -> Dict:
        return self.ring.history(last=last)

    def status(self) -> Dict:
        return self.ring.status()
