"""The client node agent: fingerprint -> register -> heartbeat ->
watch allocations -> run tasks -> push status.

Reference semantics: client/client.go (registerAndHeartbeat:1526,
watchAllocations:1969 long-poll diff by modify index, runAllocs:2190),
client/allocrunner (task fan-out, status aggregation), taskrunner
(restart policy, kill handling).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..models import (
    Allocation, Node, NodeResources, TaskState, TaskEvent,
    ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED, ALLOC_CLIENT_PENDING,
    ALLOC_CLIENT_RUNNING,
    NODE_STATUS_INIT, NODE_STATUS_READY,
)
from ..models.alloc import TASK_STATE_DEAD, TASK_STATE_PENDING, TASK_STATE_RUNNING
from ..models.resources import (NodeCpuResources, NodeDiskResources,
                                NodeMemoryResources)
from ..utils.ids import generate_uuid
from .drivers import DRIVER_CATALOG, TaskHandle
from ..utils.locks import make_lock

LOG = logging.getLogger("nomad_tpu.client")


@dataclass
class ClientConfig:
    node_name: str = ""
    datacenter: str = "dc1"
    node_class: str = ""
    cpu_shares: int = 4000
    memory_mb: int = 8192
    disk_mb: int = 100 * 1024
    # docker registers only when a reachable dockerd answers /version;
    # hosts without it drop the driver (and its node attribute) cleanly
    # conditional drivers (docker/java/qemu) drop out cleanly when
    # their binary/daemon is absent (the available() probe)
    drivers: tuple = ("mock_driver", "raw_exec", "exec", "docker",
                      "java", "qemu")
    meta: dict = field(default_factory=dict)
    poll_interval_s: float = 0.2
    heartbeat_interval_s: float = 3.0
    # durable state: when set, alloc/task/driver-handle transitions
    # persist here and a restarted client restores + re-attaches
    # (client/state/state_database.go)
    state_dir: Optional[str] = None
    # base directory for per-alloc dir trees (client/allocdir);
    # empty -> the system temp dir
    alloc_dir: str = ""
    # device fingerprinting: statically declared device groups
    # (NodeDeviceResource) plus optional CUDA card autodetection
    # through torch.cuda (devices/gpu/nvidia fingerprint)
    devices: tuple = ()
    fingerprint_accelerators: bool = False
    # drivers to run behind the plugin PROCESS boundary
    # (plugins/driver_client.py; go-plugin analog) instead of in-proc
    plugin_drivers: tuple = ()
    # accelerator fingerprint via the out-of-proc device plugin
    # (plugins/device_client.py) instead of in-proc probing
    plugin_device_fingerprint: bool = False
    # client RPC listener serving logs/fs/exec to forwarding servers
    # (client/fs_endpoint.go, client/alloc_endpoint.go); port 0 picks
    # an ephemeral port, None disables the listener. rpc_host is the
    # bind address; rpc_advertise is what goes on the node record for
    # servers to dial (cross-host deployments must set it to a
    # reachable address — loopback only works single-machine)
    rpc_port: Optional[int] = 0
    rpc_host: str = "127.0.0.1"
    rpc_advertise: str = ""
    # CSI plugins (client/csimanager, plugins/csi_client) are not
    # carried yet: a non-empty tuple raises ValueError at Client()
    csi_plugins: tuple = ()
    # cloud environment probes (client/fingerprint.py — env_aws.go,
    # env_gce.go, env_azure.go analogs). Off by default: a non-cloud
    # host would pay three metadata-timeout round trips per agent
    # start; the agent's -cloud-fingerprint or its config turns it on.
    # cloud_metadata_urls maps "aws" / "gce" / "azure" to the metadata
    # base URL each probe asks in place of its link-local default
    cloud_fingerprint: bool = False
    cloud_metadata_urls: dict = field(default_factory=dict)
    # host/alloc stats sampler (client/stats.py): cadence of
    # the /proc + driver-stats sample loop and the retained ring's
    # depth per series. 0 builds no sampler at all — no ring,
    # no stats heartbeat payload, stats routes report the node dark
    stats_sample_interval_s: float = 1.0
    stats_ring_slots: int = 128


CSI_NOT_CARRIED = (
    "csi_plugins: CSI (client/csimanager.py, plugins/csi_client.py) is "
    "not ported yet (ROADMAP queue 1 item 5)")


def _host_has_nvidia_device() -> bool:
    """The host shows an NVIDIA card: a /dev/nvidia<N> device node."""
    import glob
    return bool(glob.glob("/dev/nvidia[0-9]*"))


def fingerprint_accelerator_devices():
    """Detect the locally attached CUDA cards as one device group
    (devices/gpu/nvidia/device.go Fingerprint): type "gpu", vendor
    "nvidia", the first card's name in lower case with spaces as "-",
    instances gpu-<index>. Returns [] when torch has no CUDA build or
    the host has no NVIDIA card; otherwise CUDA is initialised, so a
    broken driver or context raises instead of leaving the node without
    its cards (torch.cuda.is_available() would swallow it)."""
    from ..models import NodeDevice, NodeDeviceResource
    import torch
    if not torch.backends.cuda.is_built() or not _host_has_nvidia_device():
        return []
    torch.cuda.init()
    n = torch.cuda.device_count()
    name = torch.cuda.get_device_name(0)
    return [NodeDeviceResource(
        vendor="nvidia", type="gpu",
        name=str(name).replace(" ", "-").lower(),
        attributes={"count": n},
        instances=[NodeDevice(id=f"gpu-{i}", healthy=True)
                   for i in range(n)])]


class TaskRunner:
    """One task's lifecycle: start -> wait -> restart policy -> dead
    (taskrunner/task_runner.go Run:456, shouldRestart:699). An attached
    handle (restored via driver RecoverTask, task_runner.go:996) skips
    the initial start and resumes at the wait."""

    def __init__(self, alloc: Allocation, task, driver, on_update,
                 attached: Optional[TaskHandle] = None,
                 node=None, alloc_dir=None, derive_vault=None,
                 vault=None, attached_vault_lease: Optional[dict] = None,
                 volume_sources: Optional[Dict[str, str]] = None,
                 stats_poll: bool = True):
        self.alloc = alloc
        self.task = task
        self.driver = driver
        self.on_update = on_update
        # legacy per-task gauge poll: superseded by the client's
        # HostStatsCollector pull — only armed when no
        # collector covers this task (kill switch / harness callers),
        # so a node never pays BOTH a poll thread and the pull
        self.stats_poll = stats_poll
        self.node = node
        self.alloc_dir = alloc_dir
        self.derive_vault = derive_vault
        # VaultTokenRenewer (client/vaultclient.py): renewal loop +
        # re-derive-on-expiry; derive_vault stays as the bare-derive
        # fallback for harness callers without a renewer
        self.vault = vault
        self._secrets_path = ""
        # current lease, persisted with task state so a restarted
        # client re-registers it with the fresh renewer (the reference
        # persists the token in the task's local state —
        # taskrunner/vault_hook.go + state DB)
        self.vault_lease: Optional[dict] = None
        self._attached_vault_lease = attached_vault_lease
        # group volume name -> host source path (csi publish target or
        # host volume path), resolved by the alloc runner's volume hook
        self.volume_sources = volume_sources or {}
        self.state = TaskState(state=TASK_STATE_PENDING)
        self.handle: Optional[TaskHandle] = None
        self._attached = attached
        self._kill = threading.Event()
        self._force_restart = False     # `alloc restart` (no budget)
        self._thread: Optional[threading.Thread] = None

    def _prestart(self):
        """Prestart hook pipeline (taskrunner hooks: allocdir env,
        artifact fetch, template render) + driver config interpolation.
        Returns (config, env) or raises HookError."""
        from .hooks import fetch_artifacts, render_templates
        from .taskenv import build_task_env, interpolate_config
        alloc_path = task_path = secrets_path = ""
        log_dir = None
        if self.alloc_dir is not None:
            alloc_path = self.alloc_dir.shared
            task_path, local, secrets_path = \
                self.alloc_dir.task_paths(self.task.name)
            log_dir = self.alloc_dir.logs
        env = build_task_env(self.alloc, self.task, self.node,
                             alloc_dir=alloc_path, task_dir=task_path,
                             secrets_dir=secrets_path)
        # vault hook (taskrunner/vault_hook.go): derive a TTL'd token,
        # expose it as VAULT_TOKEN / secrets/vault_token, and register
        # it with the renewal loop (client/vaultclient.py); on renewal
        # failure the renewer re-derives and change_mode applies
        self._secrets_path = secrets_path
        if self.task.vault is not None and \
                (self.vault is not None or self.derive_vault is not None):
            try:
                if self.vault is not None:
                    lease = self.vault.derive(self.alloc.id,
                                              self.task.name)
                    self.vault.track(self.alloc.id, self.task.name,
                                     lease,
                                     on_new_token=self._on_new_vault_token)
                else:
                    from .vaultclient import _normalize
                    tokens = self.derive_vault(self.alloc.id,
                                               [self.task.name])
                    lease = _normalize(tokens.get(self.task.name))
                self.vault_lease = lease
                token = lease.get("token", "")
                if self.task.vault.env:
                    env["VAULT_TOKEN"] = token
                self._write_vault_token(token)
            except Exception as e:
                from .hooks import HookError
                raise HookError(f"vault token derivation failed: {e}")
        if self.alloc_dir is not None:
            fetch_artifacts(self.task, task_path, env, self.node)
            render_templates(self.task, task_path, env, self.node)
        config = interpolate_config(self.task.config, env, self.node)
        # typed config validation against the driver's declared schema
        # (plugins/shared/hclspec): unknown keys and type mismatches
        # fail the task at prestart with a spec error instead of deep
        # inside the driver; defaults fill in
        spec = None
        spec_getter = getattr(self.driver, "config_spec", None)
        if spec_getter is not None:
            try:
                spec = spec_getter()
            except Exception:
                spec = None
        else:
            spec = getattr(self.driver, "CONFIG_SPEC", None)
        if spec:
            from ..plugins.hclspec import SpecError, decode
            from .hooks import HookError
            try:
                config = decode(spec, config)
            except SpecError as e:
                raise HookError(f"driver config invalid: {e}")
        lc = self.task.log_config
        # the alloc's port offers ride into the driver ctx so port_map
        # can bind container ports to the scheduler-assigned host
        # ports (drivers/docker port_map)
        from ..utils.codec import to_wire as _to_wire
        alloc_networks = []
        if self.alloc.allocated_resources is not None:
            ar = self.alloc.allocated_resources
            # wire-shaped: ctx crosses the plugin msgpack boundary
            alloc_networks.extend(
                _to_wire(nw) for nw in (ar.shared.networks or []))
            tr = ar.tasks.get(self.task.name)
            if tr is not None:
                alloc_networks.extend(
                    _to_wire(nw) for nw in (tr.networks or []))
        # volume_mount stanzas resolve against the alloc runner's
        # mounted volume sources (csi publish targets / host volume
        # paths) — drivers receive [{volume, source, destination,
        # read_only}] (taskrunner/volume_hook.go)
        volume_mounts = []
        for vm in (self.task.volume_mounts or []):
            src = self.volume_sources.get(vm.volume)
            if src is None:
                from .hooks import HookError
                raise HookError(
                    f"volume_mount references undefined volume "
                    f"{vm.volume!r}")
            volume_mounts.append({"volume": vm.volume, "source": src,
                                  "destination": vm.destination,
                                  "read_only": bool(vm.read_only)})
        ctx = {"task_dir": task_path or None,
               "volume_mounts": volume_mounts,
               "log_dir": log_dir,
               "log_max_files": lc.max_files if lc else 10,
               "log_max_file_size_mb": lc.max_file_size_mb if lc else 10,
               "alloc_id": self.alloc.id,
               "user": self.task.user,
               "alloc_networks": alloc_networks,
               "resources": {"cpu": self.task.resources.cpu,
                             "memory_mb": self.task.resources.memory_mb}}
        return config, env, ctx

    def _write_vault_token(self, token: str) -> None:
        """secrets/vault_token (vault_hook.go writeToken). Raises on
        write failure — for a task with vault.env=false this file is
        the only token delivery channel, so prestart must fail loudly
        (the hook wraps it in a HookError)."""
        if self._secrets_path and token:
            import os
            path = os.path.join(self._secrets_path, "vault_token")
            with open(path, "w") as f:
                f.write(token)
            os.chmod(path, 0o600)

    def _on_new_vault_token(self, lease: dict) -> None:
        """Renewal-failure re-derive landed a fresh token: persist it
        and apply the task's change_mode (vault_hook.go updatedToken)."""
        token = lease.get("token", "")
        self.vault_lease = dict(lease)
        try:
            self._write_vault_token(token)
        except OSError:
            LOG.exception("vault token write failed for %s",
                          self.task.name)
        self.on_update()        # persist the fresh lease
        mode = self.task.vault.change_mode if self.task.vault else "noop"
        # a task that already exited must not be signalled or force-
        # restarted outside its restart policy — the new token is on
        # disk for whatever runs next. Act on the snapshotted handle
        # throughout: self.handle may be swapped by the run loop
        # mid-callback.
        h = self.handle
        if h is None or h.done():
            return
        if mode == "signal":
            sig = self.task.vault.change_signal or "SIGHUP"
            signal_fn = getattr(self.driver, "signal_task", None)
            if signal_fn is not None:
                try:
                    signal_fn(h, sig)
                    return
                except Exception:
                    pass
            mode = "restart"    # signal unsupported: fall back
        if mode == "restart":
            self._force_restart = True
            try:
                self.driver.stop_task(h, self.task.kill_timeout_s)
            except Exception:
                pass

    def _revault_on_attach(self) -> None:
        """A re-attached task's lease must keep renewing: the restarted
        client's renewer is empty, so re-register the persisted lease
        (renewing immediately — its remaining TTL is unknown) or, if
        none survived, derive fresh (vault_hook restore path)."""
        if self.task.vault is None or self.vault is None:
            return
        if self.alloc_dir is not None and not self._secrets_path:
            _tp, _lc, self._secrets_path = \
                self.alloc_dir.task_paths(self.task.name)
        lease = self._attached_vault_lease
        self._attached_vault_lease = None
        try:
            if lease and lease.get("accessor"):
                self.vault_lease = dict(lease)
                self.vault.track(self.alloc.id, self.task.name, lease,
                                 on_new_token=self._on_new_vault_token,
                                 renew_now=True)
            else:
                lease = self.vault.derive(self.alloc.id, self.task.name)
                self.vault_lease = dict(lease)
                self.vault.track(self.alloc.id, self.task.name, lease,
                                 on_new_token=self._on_new_vault_token)
                self._write_vault_token(lease.get("token", ""))
        except Exception:
            LOG.exception("vault lease re-registration failed for %s",
                          self.task.name)

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name=f"task-{self.task.name}")
        self._thread.start()

    def _start_stats_poll(self, handle) -> None:
        """Task resource gauges while the task runs (task_runner.go
        :1297-1370 emitStats -> nomad.client.allocs.* gauges), fed by
        the driver's executor stats when it has one. Skipped when the
        client's HostStatsCollector already pulls this driver's stats
        (stats_poll=False): one reader per task, not two."""
        if not self.stats_poll:
            return
        stats_fn = getattr(self.driver, "stats", None)
        if stats_fn is None:
            return

        def poll():
            from ..utils import metrics
            prefix = f"nomad.client.allocs.{self.alloc.id[:8]}." \
                     f"{self.task.name}"
            while not handle.done():
                try:
                    for k, v in (stats_fn(handle) or {}).items():
                        metrics.set_gauge(f"{prefix}.{k}", v)
                except Exception:
                    pass
                time.sleep(1.0)

        threading.Thread(target=poll, daemon=True,
                         name=f"stats-{self.task.name}").start()

    def kill(self) -> None:
        self._kill.set()
        if self.handle is not None:
            self.driver.stop_task(self.handle, self.task.kill_timeout_s)

    def run(self) -> None:
        try:
            self._run()
        finally:
            # stop renewing this task's vault lease; server-side
            # revocation rides the alloc's terminal status update
            if self.vault is not None:
                self.vault.untrack(self.alloc.id, self.task.name)

    def _run(self) -> None:
        tg = self.alloc.job.lookup_task_group(self.alloc.task_group) \
            if self.alloc.job else None
        policy = tg.restart_policy if tg else None
        restarts = 0
        while not self._kill.is_set():
            if self._attached is not None:
                self.handle = self._attached
                self._attached = None
                started_at = self.handle.started_at or time.time()
                self._revault_on_attach()
            else:
                try:
                    from .hooks import HookError
                    config, env, ctx = self._prestart()
                    self.handle = self.driver.start_task(
                        self.task.name, config, env, ctx=ctx)
                except (RuntimeError, OSError, HookError) as e:
                    # OSError: isolation setup (cgroupfs writes) can
                    # fail at start; it must surface as a failed task,
                    # not a dead runner thread stuck in PENDING
                    kind = "Setup Failure" if isinstance(
                        e, HookError) else "Driver Failure"
                    self.state = TaskState(
                        state=TASK_STATE_DEAD, failed=True,
                        finished_at=time.time(),
                        events=[TaskEvent(type=kind,
                                          message=str(e),
                                          failed=True,
                                          time=int(time.time()))])
                    self.on_update()
                    return
                started_at = time.time()
            self.state = TaskState(state=TASK_STATE_RUNNING,
                                   started_at=started_at,
                                   restarts=restarts)
            self.on_update()
            self._start_stats_poll(self.handle)
            self.handle.wait()
            exit_code = self.handle.exit_code or 0
            failed = exit_code != 0
            if self._kill.is_set():
                self.state = TaskState(state=TASK_STATE_DEAD, failed=False,
                                       restarts=restarts,
                                       started_at=self.state.started_at,
                                       finished_at=time.time())
                self.on_update()
                return
            # a user-requested restart (`nomad alloc restart`) loops
            # unconditionally — any exit code, no attempt consumed
            # (the reference restarts outside the policy budget)
            if self._force_restart:
                self._force_restart = False
                self.state = TaskState(
                    state=TASK_STATE_PENDING, restarts=restarts,
                    events=[TaskEvent(type="Restart Signaled",
                                      exit_code=exit_code,
                                      time=int(time.time()))])
                self.on_update()
                continue
            # restart within the attempt budget regardless of mode; mode
            # only governs post-exhaustion behavior (restarts/restarts.go:
            # "delay" waits out the interval, "fail" marks the task dead)
            if failed and policy is not None and restarts < policy.attempts:
                restarts += 1
                # visible restart transition: the alloc health monitor
                # must see the task leave "running" or a crash-looping
                # task would be reported deployment-healthy
                self.state = TaskState(
                    state=TASK_STATE_PENDING, restarts=restarts,
                    events=[TaskEvent(type="Restarting", exit_code=exit_code,
                                      failed=failed, time=int(time.time()))])
                self.on_update()
                self._kill.wait(min(policy.delay_s, 0.2))  # test-friendly cap
                continue
            self.state = TaskState(
                state=TASK_STATE_DEAD, failed=failed, restarts=restarts,
                started_at=self.state.started_at, finished_at=time.time(),
                events=[TaskEvent(type="Terminated", exit_code=exit_code,
                                  failed=failed, time=int(time.time()))])
            self.on_update()
            return


class AllocRunner:
    """Per-allocation lifecycle (allocrunner/alloc_runner.go Run:282,
    clientAlloc:616 status aggregation)."""

    def __init__(self, alloc: Allocation, drivers: Dict[str, object],
                 push_update, persist=None, node=None,
                 alloc_dir_base: str = "", derive_vault=None,
                 vault=None, client=None):
        self.alloc = alloc
        self.drivers = drivers
        self.push_update = push_update
        self.persist = persist            # (alloc_id, task, state, handle)
        self.derive_vault = derive_vault
        self.vault = vault                # VaultTokenRenewer
        self.node = node
        self.client = client              # alloc-watcher context
        self.task_runners: List[TaskRunner] = []
        # the collector's pull supersedes per-task poll threads
        self._stats_poll = getattr(client, "host_stats", None) is None
        self.client_status = ALLOC_CLIENT_PENDING
        self.deployment_status = alloc.deployment_status
        self._l = make_lock()
        self.destroyed = False
        # volume name -> host source path tasks mount from (filled by
        # _mount_volumes: CSI publish targets + host volume paths)
        self.volume_sources: Dict[str, str] = {}
        self._csi_mounted: List[Tuple[str, str]] = []  # (plugin, vol)
        from .allocdir import AllocDir
        self.alloc_dir = AllocDir(alloc_dir_base, alloc.id)
        self.services = None
        transport = getattr(client, "transport", None)
        if transport is not None:
            from .services_hook import AllocServices
            self.services = AllocServices(self, transport)

    def run(self, attached: Optional[Dict[str, TaskHandle]] = None,
            attached_leases: Optional[Dict[str, dict]] = None) -> None:
        """Start (or, with `attached` handles from driver recovery,
        resume) the alloc's tasks."""
        tg = self.alloc.job.lookup_task_group(self.alloc.task_group) \
            if self.alloc.job else None
        if tg is None:
            self.client_status = ALLOC_CLIENT_FAILED
            self._push()
            return
        self.alloc_dir.build([t.name for t in tg.tasks])
        # csi_hook (allocrunner/csi_hook.go): stage + publish every CSI
        # volume the group requests before any task starts; a mount
        # failure fails the alloc at setup
        try:
            self._mount_volumes(tg)
        except Exception as e:
            LOG.exception("volume setup failed for %s", self.alloc.id[:8])
            for task in tg.tasks:
                tr = TaskRunner(self.alloc, task, self.drivers.get(
                    task.driver), self._on_task_update)
                tr.state = TaskState(
                    state=TASK_STATE_DEAD, failed=True,
                    finished_at=time.time(),
                    events=[TaskEvent(type="Setup Failure",
                                      message=f"volume mount: {e}",
                                      failed=True, time=int(time.time()))])
                self.task_runners.append(tr)
            self._on_task_update()
            return
        for task in tg.tasks:
            driver = self.drivers.get(task.driver)
            if driver is None:
                self.client_status = ALLOC_CLIENT_FAILED
                self._push()
                return
            tr = TaskRunner(self.alloc, task, driver, self._on_task_update,
                            attached=(attached or {}).get(task.name),
                            node=self.node, alloc_dir=self.alloc_dir,
                            derive_vault=self.derive_vault,
                            vault=self.vault,
                            attached_vault_lease=(attached_leases or {})
                            .get(task.name),
                            volume_sources=self.volume_sources,
                            stats_poll=self._stats_poll)
            self.task_runners.append(tr)
        # previous-alloc watcher (client/allocwatcher): a replacement
        # with a sticky/migrating ephemeral disk waits for its
        # predecessor and pulls the disk before tasks start — on its
        # own thread so other allocs keep flowing
        needs_watch = (
            self.client is not None and not attached
            and self.alloc.previous_allocation
            and tg.ephemeral_disk is not None
            and (tg.ephemeral_disk.sticky or tg.ephemeral_disk.migrate))

        def _start_tasks_and_health():
            for tr in self.task_runners:
                tr.start()
            # service registration + health checking (groupservice_hook
            # + taskrunner service_hook): registrations go to the
            # built-in catalog through the client transport
            if self.services is not None:
                self.services.start()
            # the deployment health clock starts only once tasks are
            # actually released — ticking through the migration wait
            # would expire healthy_deadline before tasks ever ran
            if self.alloc.deployment_id and tg.update is not None:
                threading.Thread(target=self._watch_health,
                                 args=(tg.update,), daemon=True,
                                 name=f"health-{self.alloc.id[:8]}"
                                 ).start()

        if needs_watch:
            def _watch_then_start():
                from .allocwatcher import migrate_previous
                try:
                    if not self.destroyed:
                        migrate_previous(self.client, self)
                except Exception:
                    LOG.exception("alloc watcher for %s failed; "
                                  "starting with a fresh disk",
                                  self.alloc.id[:8])
                if self.destroyed:
                    # the server stopped this alloc mid-wait: the
                    # tasks must land terminal, not PENDING forever,
                    # and nothing may write into the destroyed dir
                    for tr in self.task_runners:
                        tr.state = TaskState(state=TASK_STATE_DEAD,
                                             finished_at=time.time())
                    self._on_task_update()
                    return
                _start_tasks_and_health()
            threading.Thread(target=_watch_then_start, daemon=True,
                             name=f"allocwatch-{self.alloc.id[:8]}"
                             ).start()
        else:
            _start_tasks_and_health()

    def _watch_health(self, update) -> None:
        """Deployment health monitor (allocrunner/health_hook.go +
        allochealth/tracker.go): healthy once every task has been running
        continuously for min_healthy_time; unhealthy on task failure or
        when healthy_deadline expires first."""
        deadline = time.time() + update.healthy_deadline_s
        healthy_since: Optional[float] = None
        seen_restarts = -1
        while not self.destroyed:
            with self._l:
                states = [tr.state for tr in self.task_runners]
            if any(ts.state == TASK_STATE_DEAD and ts.failed for ts in states):
                self._set_health(False)
                return
            restarts = sum(ts.restarts for ts in states)
            if restarts != seen_restarts:
                # a restart resets the continuous-running clock
                # (allochealth/tracker.go watchTaskEvents)
                seen_restarts = restarts
                healthy_since = None
            if states and all(ts.state == TASK_STATE_RUNNING for ts in states):
                now = time.time()
                started = max(ts.started_at or now for ts in states)
                since = max(healthy_since or started, started)
                healthy_since = since
                if now - since >= update.min_healthy_time_s:
                    self._set_health(True)
                    return
            else:
                healthy_since = None
            if time.time() > deadline:
                self._set_health(False)
                return
            time.sleep(0.05)

    def _set_health(self, healthy: bool) -> None:
        from ..models.alloc import AllocDeploymentStatus
        canary = bool(self.alloc.deployment_status
                      and self.alloc.deployment_status.canary)
        self.deployment_status = AllocDeploymentStatus(
            healthy=healthy, timestamp=time.time(), canary=canary)
        self._push()

    def _mount_volumes(self, tg) -> None:
        """Resolve the group's volume requests into task-mountable
        source paths: host volumes from the node's host_volume config,
        CSI volumes via stage/publish through the csimanager."""
        if not tg.volumes:
            return
        csi = getattr(self.client, "csi_manager", None) \
            if self.client is not None else None
        transport = getattr(self.client, "transport", None) \
            if self.client is not None else None
        for name, req in tg.volumes.items():
            vtype = getattr(req, "type", "host") or "host"
            if vtype == "host":
                hv = (self.node.host_volumes or {}).get(req.source) \
                    if self.node is not None else None
                if hv and hv.get("path"):
                    self.volume_sources[name] = hv["path"]
                elif self.node is not None and self.node.host_volumes:
                    # the scheduler filtered on host volumes, so a miss
                    # here is a real config error — fail setup loudly
                    # instead of a misleading per-task mount error
                    raise RuntimeError(
                        f"host volume {req.source!r} not present on "
                        "this node")
                continue
            if vtype != "csi":
                continue
            if csi is None or transport is None:
                raise RuntimeError(
                    f"csi volume {req.source}: no csi plugins configured")
            info = transport.get_csi_volume(self.alloc.namespace,
                                            req.source)
            if not info:
                raise RuntimeError(f"csi volume {req.source} not found")
            plugin_id = info.get("plugin_id", "")
            target = csi.mount_volume(plugin_id, req.source,
                                      self.alloc.id,
                                      bool(req.read_only))
            if target is None:
                raise RuntimeError(
                    f"csi plugin {plugin_id!r} not available on node")
            self._csi_mounted.append((plugin_id, req.source))
            self.volume_sources[name] = target

    def _unmount_volumes(self) -> None:
        csi = getattr(self.client, "csi_manager", None) \
            if self.client is not None else None
        if csi is None:
            self._csi_mounted = []
            return
        for plugin_id, vol_id in self._csi_mounted:
            csi.unmount_volume(plugin_id, vol_id, self.alloc.id)
        self._csi_mounted = []

    def stop(self) -> None:
        self.destroyed = True
        if self.services is not None:
            self.services.stop()
        for tr in self.task_runners:
            tr.kill()
        self._unmount_volumes()

    def destroy(self) -> None:
        """Release the alloc's directory tree (client GC)."""
        if not self.destroyed:
            self.stop()
        self._unmount_volumes()
        self.alloc_dir.destroy()

    def _on_task_update(self) -> None:
        if self.persist is not None:
            for tr in self.task_runners:
                self.persist(
                    self.alloc.id, tr.task.name, tr.state,
                    tr.handle.recoverable_state() if tr.handle else None,
                    tr.vault_lease)
        with self._l:
            states = {tr.task.name: tr.state for tr in self.task_runners}
            # aggregate client status (alloc_runner.go getClientStatus)
            if any(ts.state == TASK_STATE_DEAD and ts.failed
                   for ts in states.values()):
                status = ALLOC_CLIENT_FAILED
            elif all(ts.state == TASK_STATE_DEAD for ts in states.values()):
                status = ALLOC_CLIENT_COMPLETE
            elif any(ts.state == TASK_STATE_RUNNING for ts in states.values()):
                status = ALLOC_CLIENT_RUNNING
            else:
                status = ALLOC_CLIENT_PENDING
            self.client_status = status
        # terminal allocs leave the catalog even without an explicit
        # stop (batch tasks finishing; groupservice_hook Postrun)
        if status in (ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED):
            if self.services is not None:
                self.services.stop()
            # csi_hook Postrun: release this alloc's volume mounts —
            # but only once EVERY task has exited. A failed sibling
            # flips aggregate status to FAILED while other tasks still
            # run; unmounting then would yank the volume out from
            # under them (the reference's Postrun runs after all task
            # runners exit).
            if all(ts.state == TASK_STATE_DEAD
                   for ts in states.values()):
                self._unmount_volumes()
        self._push()

    def _push(self) -> None:
        states = {tr.task.name: tr.state for tr in self.task_runners}
        self.push_update(Allocation(
            id=self.alloc.id, client_status=self.client_status,
            task_states=states, deployment_status=self.deployment_status,
            modify_time=int(time.time())))


class Client:
    """The node agent. Talks to the server through the narrow
    ServerTransport surface (rpc/transport.py): direct method calls
    in-process (dev agent), or the wire RPC layer in a real cluster.
    Accepts either a Server object (wrapped in InProcTransport, the
    historical signature) or any ServerTransport."""

    def __init__(self, server, config: Optional[ClientConfig] = None):
        from ..rpc.transport import InProcTransport, ServerTransport
        if isinstance(server, ServerTransport):
            self.transport = server
            self.server = getattr(server, "server", None)
        else:
            self.transport = InProcTransport(server)
            self.server = server
        self.config = config or ClientConfig()
        from .vaultclient import VaultTokenRenewer
        self.vault_renewer = VaultTokenRenewer(self.transport)
        # CSI (client/pluginmanager/csimanager) is not carried: a client
        # has no CSI manager, and a group's csi volume fails its setup
        if self.config.csi_plugins:
            raise ValueError(CSI_NOT_CARRIED)
        self.csi_manager = None
        self.state_db = None
        if self.config.state_dir:
            from .state_db import ClientStateDB
            self.state_db = ClientStateDB(self.config.state_dir)
        self.node = self._fingerprint()
        self.drivers = {}
        for name in self.config.drivers:
            if name in self.config.plugin_drivers:
                from ..plugins import ExternalDriver
                self.drivers[name] = ExternalDriver(name)
            else:
                self.drivers[name] = DRIVER_CATALOG[name]()
        # CONDITIONAL drivers (docker): only drivers that declare an
        # availability probe get filtered — calling fingerprint() on a
        # plugin driver here would spawn its subprocess at construction
        # and permanently drop it on one transient handshake failure,
        # defeating the relaunch supervision
        for name, drv in list(self.drivers.items()):
            probe = getattr(drv, "available", None)
            if probe is None:
                continue
            try:
                ok = probe()
                fp = drv.fingerprint() if ok else {}
            except Exception:
                ok, fp = False, {}
            if not ok or not fp:
                del self.drivers[name]
                self.node.attributes.pop(f"driver.{name}", None)
                self.node.drivers.pop(name, None)
            else:
                self.node.attributes.update(fp)
        self.runners: Dict[str, AllocRunner] = {}
        # host/alloc stats sampler: built here so tests can
        # drive sample_once() before start(); the thread starts in
        # start(). An interval of 0 builds nothing — the degenerate
        # path is the pre-stats client
        self.host_stats = None
        from . import stats as client_stats
        if self.config.stats_sample_interval_s > 0:
            self.host_stats = client_stats.HostStatsCollector(
                client=self,
                interval_s=self.config.stats_sample_interval_s,
                slots=self.config.stats_ring_slots,
                alloc_dir=self.config.alloc_dir)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._seen_index = 0

    # -- fingerprinting (client/fingerprint) ---------------------------
    def _fingerprint(self) -> Node:
        from ..models import DriverInfo, NetworkResource
        # stable node identity across restarts (client.go persists the
        # node ID in the data dir) — without it a restarted client would
        # register as a new node and orphan its allocs
        node_id = secret = None
        if self.state_db is not None:
            ident = self.state_db.load_identity()
            if ident:
                node_id = ident.get("node_id")
                secret = ident.get("secret_id")
        node = Node(
            id=node_id or generate_uuid(),
            secret_id=secret or generate_uuid(),
            name=self.config.node_name or f"client-{generate_uuid()[:8]}",
            datacenter=self.config.datacenter,
            node_class=self.config.node_class,
            status=NODE_STATUS_INIT,
            attributes={
                "kernel.name": "linux",
                "arch": "x86",
                "nomad.version": "0.1.0",
                # the embedded token authority makes every server
                # vault-capable, so every client fingerprints it
                # (fingerprint/vault.go; satisfies the implied
                # ${attr.vault.version} constraint on vault jobs)
                "vault.version": "1.0-embedded",
                "vault.accessible": "true",
            },
            meta=dict(self.config.meta),
            node_resources=NodeResources(
                cpu=NodeCpuResources(cpu_shares=self.config.cpu_shares),
                memory=NodeMemoryResources(memory_mb=self.config.memory_mb),
                disk=NodeDiskResources(disk_mb=self.config.disk_mb),
                networks=[NetworkResource(mode="host", device="eth0",
                                          ip="127.0.0.1", mbits=1000)],
            ),
        )
        for name in self.config.drivers:
            node.attributes[f"driver.{name}"] = "1"
            from ..models import DriverInfo as DI
            node.drivers[name] = DI(detected=True, healthy=True)
        node.node_resources.devices = list(self.config.devices)
        if self.config.fingerprint_accelerators:
            if self.config.plugin_device_fingerprint:
                # out-of-proc device plugin (plugins/device/device.go
                # behind the go-plugin boundary): fingerprint crosses
                # the process line, and a crashing device plugin can't
                # take the agent down
                from ..plugins.device_client import ExternalDevicePlugin
                self.device_plugin = ExternalDevicePlugin()
                try:
                    node.node_resources.devices.extend(
                        self.device_plugin.fingerprint())
                except Exception:
                    # same contract as the in-proc probe: a broken
                    # device plugin means no devices, not a dead agent
                    LOG.exception("device plugin fingerprint failed; "
                                  "continuing without devices")
            else:
                node.node_resources.devices.extend(
                    fingerprint_accelerator_devices())
        for g in node.node_resources.devices:
            node.attributes[f"device.{g.type}"] = str(len(g.instances))
        if self.config.cloud_fingerprint:
            from .fingerprint import fingerprint_cloud
            attrs, links = fingerprint_cloud(
                urls=self.config.cloud_metadata_urls)
            node.attributes.update(attrs)
            node.links.update(links)
        node.compute_class()
        if self.state_db is not None:
            self.state_db.save_identity(node.id, node.secret_id)
        return node

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        self.node.status = NODE_STATUS_READY
        # the logs/fs/exec service: servers forward remote requests to
        # this listener; its address rides the node record so any
        # server can find the owning client (the reference advertises
        # client ports on the Node the same way)
        if self.config.rpc_port is not None:
            from ..rpc.server import RpcServer
            from .remote import ClientRpcService
            self.rpc_service = ClientRpcService(self)
            self.rpc_server = RpcServer(
                host=self.config.rpc_host,
                port=self.config.rpc_port,
                methods=self.rpc_service.rpc_methods())
            self.rpc_server.start()
            advertise = self.config.rpc_advertise or \
                f"{self.config.rpc_host}:{self.rpc_server.port}"
            self.node.attributes["nomad.client.rpc"] = advertise
        self.transport.register_node(self.node)
        self.transport.update_node_status(self.node.id, NODE_STATUS_READY)
        self._restore_state()
        docker = self.drivers.get("docker")
        if docker is not None and hasattr(docker, "start_reconciler"):
            # orphan-container sweep (drivers/docker/reconciler.go)
            docker.start_reconciler(lambda: set(self.runners))
        if self.host_stats is not None:
            # prime one sample synchronously so the first heartbeat
            # already carries a stats payload, then background-sample
            self.host_stats.sample_once()
            self.host_stats.start()
        t1 = threading.Thread(target=self._heartbeat_loop, daemon=True)
        t2 = threading.Thread(target=self._watch_allocs, daemon=True)
        self._threads = [t1, t2]
        t1.start()
        t2.start()

    def alloc_base(self, alloc_id: str) -> Optional[str]:
        """Filesystem base of one alloc's dir tree on this node, or
        None when the alloc doesn't live here."""
        runner = self.runners.get(alloc_id)
        if runner is not None:
            return runner.alloc_dir.base
        from .allocdir import AllocDir
        base = AllocDir(self.config.alloc_dir, alloc_id).base
        return base if os.path.isdir(base) else None

    def _restore_state(self) -> None:
        """Rebuild alloc runners from the state DB, re-attaching to live
        tasks via driver RecoverTask (client.go restoreState:1055,
        task_runner.go:996). Unrecoverable tasks restart fresh."""
        if self.state_db is None:
            return
        from ..models import Allocation
        from ..utils.codec import from_wire
        for aid, rec in list(self.state_db.state.items()):
            alloc_data = rec.get("alloc")
            if not alloc_data:
                continue
            alloc = from_wire(Allocation, alloc_data)
            if alloc.terminal_status() or alloc.server_terminal_status():
                self.state_db.delete_alloc(aid)
                continue
            attached: Dict[str, TaskHandle] = {}
            attached_leases: Dict[str, dict] = {}
            for task_name, tstate in (rec.get("tasks") or {}).items():
                lease = tstate.get("vault_lease")
                if lease:
                    attached_leases[task_name] = lease
                hstate = tstate.get("handle")
                if not hstate:
                    continue
                # only re-attach tasks that were last seen running
                st = (tstate.get("state") or {}).get("state")
                if st != TASK_STATE_RUNNING:
                    continue
                driver = self.drivers.get(hstate.get("driver", ""))
                if driver is None:
                    continue
                recover = getattr(driver, "recover_task", None)
                handle = recover(hstate) if recover else None
                if handle is not None:
                    attached[task_name] = handle
                    LOG.info("re-attached task %s of alloc %s",
                             task_name, aid[:8])
            runner = AllocRunner(alloc, self.drivers, self._push_update,
                                 persist=self._persist_task,
                                 node=self.node,
                                 alloc_dir_base=self.config.alloc_dir,
                                 derive_vault=self.transport
                                 .derive_vault_token,
                                 vault=self.vault_renewer,
                                 client=self)
            # nomad-lint: allow[shared-state] _restore_state runs in start() before the _watch_allocs thread exists — Thread.start() is the happens-before edge
            self.runners[aid] = runner
            runner.run(attached=attached, attached_leases=attached_leases)

    def _persist_task(self, alloc_id, task_name, state, handle_state,
                      vault_lease=None):
        if self.state_db is not None:
            try:
                self.state_db.put_task(alloc_id, task_name, state,
                                       handle_state, vault_lease)
            except Exception:
                LOG.exception("state persist failed")

    def shutdown(self, kill_tasks: bool = True) -> None:
        """kill_tasks=False detaches without stopping tasks — the
        restart-without-killing-tasks path (the reference client leaves
        tasks running and re-attaches after restart)."""
        self._stop.set()
        self.vault_renewer.stop()
        if self.host_stats is not None:
            self.host_stats.stop()
        if kill_tasks:
            # copy: the alloc-watch thread may still mutate the dict
            # until it observes _stop
            for r in list(self.runners.values()):
                r.stop()
        for t in self._threads:
            t.join(timeout=2)
        rpc = getattr(self, "rpc_server", None)
        if rpc is not None:
            rpc.shutdown()
        devp = getattr(self, "device_plugin", None)
        if devp is not None:
            devp.shutdown()
        close = getattr(self.transport, "close", None)
        if close is not None:
            close()
        for d in self.drivers.values():
            stop = getattr(d, "shutdown", None)
            if stop is not None:
                stop()
        if self.state_db is not None:
            self.state_db.close()

    def _heartbeat_loop(self) -> None:
        interval = self.config.heartbeat_interval_s
        while not self._stop.is_set():
            try:
                # the heartbeat doubles as the host-stats uplink: a
                # compact summary (~8 floats) rides every beat so the
                # server folds fleet economics without a scrape
                # fan-out (node_endpoint.go UpdateStatus analog)
                stats = self.host_stats.summary() \
                    if self.host_stats is not None else None
                ttl = self.transport.heartbeat(self.node.id,
                                               stats=stats or None)
                # renew at half the granted TTL (client/client.go heartbeats
                # inside the server-granted TTL window, never beyond it)
                interval = min(self.config.heartbeat_interval_s, ttl / 2.0)
                self._last_heartbeat_ok = time.time()
                self._heartbeat_ttl = ttl
            except Exception:
                LOG.warning("heartbeat failed", exc_info=True)
                self._check_heartbeat_stop()
            self._stop.wait(interval)

    def _check_heartbeat_stop(self) -> None:
        """heartbeatstop.go: when the client has lost its servers past
        the heartbeat TTL, stop allocs whose task group sets
        stop_after_client_disconnect once that duration has elapsed
        since the last successful heartbeat."""
        last = getattr(self, "_last_heartbeat_ok", None)
        if last is None:
            return
        ttl = getattr(self, "_heartbeat_ttl", self.config.heartbeat_interval_s)
        offline_for = time.time() - last
        if offline_for < ttl:
            return
        for runner in list(self.runners.values()):
            if runner.destroyed:
                continue
            tg = runner.alloc.job.lookup_task_group(runner.alloc.task_group) \
                if runner.alloc.job else None
            stop_after = getattr(tg, "stop_after_client_disconnect_s",
                                 None) if tg else None
            if stop_after is None:
                continue
            if offline_for >= stop_after:
                LOG.warning(
                    "stopping alloc %s: client disconnected %.1fs "
                    "(stop_after_client_disconnect=%.1fs)",
                    runner.alloc.id[:8], offline_for, stop_after)
                runner.stop()

    # -- alloc watching (client/client.go watchAllocations:1969) -------
    def _watch_allocs(self) -> None:
        while not self._stop.is_set():
            try:
                self._run_allocs()
            except Exception:
                LOG.exception("runAllocs failed")
                self._stop.wait(self.config.poll_interval_s)

    def _run_allocs(self) -> None:
        # long-poll: the server blocks until state moves past the index
        # we've seen (or the wait expires), node_endpoint.go:926
        allocs, index = self.transport.get_client_allocs(
            self.node.id, self._seen_index,
            max(self.config.poll_interval_s, 0.05))
        self._seen_index = index
        server_allocs = {a.id: a for a in allocs}
        # start new allocs
        for aid, alloc in server_allocs.items():
            if aid in self.runners:
                continue
            if alloc.terminal_status():
                continue
            if alloc.job is None:
                continue
            runner = AllocRunner(alloc, self.drivers, self._push_update,
                                 persist=self._persist_task,
                                 node=self.node,
                                 alloc_dir_base=self.config.alloc_dir,
                                 derive_vault=self.transport
                                 .derive_vault_token,
                                 vault=self.vault_renewer,
                                 client=self)
            self.runners[aid] = runner
            if self.state_db is not None:
                self.state_db.put_alloc(alloc)
            runner.run()
        # stop allocs the server wants stopped (or that vanished)
        for aid, runner in list(self.runners.items()):
            server_alloc = server_allocs.get(aid)
            if server_alloc is None or server_alloc.server_terminal_status():
                if not runner.destroyed:
                    runner.stop()
                if self.state_db is not None:
                    self.state_db.delete_alloc(aid)
                if server_alloc is None:
                    runner.destroy()
                    del self.runners[aid]
                continue
            # prune finished runners whose final status the server has
            # acknowledged (client gc.go analog) so long-lived clients
            # running many short batch jobs don't accumulate runners.
            # The alloc DIR stays for log inspection until the server
            # garbage-collects the alloc (the None branch above).
            if runner.client_status in ("complete", "failed") and \
                    server_alloc.client_status == runner.client_status:
                if self.state_db is not None:
                    self.state_db.delete_alloc(aid)
                del self.runners[aid]

    def _push_update(self, update: Allocation) -> None:
        try:
            self.transport.update_alloc_status([update])
        except Exception:
            LOG.exception("alloc update push failed")
