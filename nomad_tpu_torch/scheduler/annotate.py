"""Plan diff annotations (scheduler/annotate.go).

`nomad job plan` shows the job diff; this pass decorates it so a human
can read consequences off the plan: task-group update counts from the
scheduler's DesiredUpdates, count-change arrows, and per-task
forces-create/destroy/in-place/destructive annotations.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# annotate.go:9-14
FORCES_CREATE = "forces create"
FORCES_DESTROY = "forces destroy"
FORCES_INPLACE = "forces in-place update"
FORCES_DESTRUCTIVE = "forces create/destroy update"

# annotate.go:17-25
UPDATE_TYPE_IGNORE = "ignore"
UPDATE_TYPE_CREATE = "create"
UPDATE_TYPE_DESTROY = "destroy"
UPDATE_TYPE_MIGRATE = "migrate"
UPDATE_TYPE_CANARY = "canary"
UPDATE_TYPE_INPLACE = "in-place update"
UPDATE_TYPE_DESTRUCTIVE = "create/destroy update"

# primitive task fields whose change does NOT force a destructive
# update (annotate.go:166-177 — KillTimeout only)
_NONDESTRUCTIVE_FIELDS = frozenset({"kill_timeout_s"})
# object changes applicable in place (annotate.go:180-193:
# LogConfig, Service, Constraint)
_INPLACE_OBJECTS = ("log_config", "services", "constraints")


def annotate(diff: Dict, annotations: Optional[Dict] = None) -> Dict:
    """Annotate a job_diff() dict in place (scheduler/annotate.go
    Annotate:38). `annotations` is {"DesiredTGUpdates": {group:
    DesiredUpdates-wire-dict}} from the scheduler's plan."""
    for tg in diff.get("TaskGroups") or []:
        _annotate_task_group(tg, annotations)
    return diff


def _annotate_task_group(tg: Dict,
                         annotations: Optional[Dict]) -> None:
    """annotateTaskGroup:54."""
    updates = ((annotations or {}).get("DesiredTGUpdates") or {}).get(
        tg.get("Name"))
    if updates:
        out = tg.setdefault("Updates", {})
        for src, label in (
                ("ignore", UPDATE_TYPE_IGNORE),
                ("place", UPDATE_TYPE_CREATE),
                ("migrate", UPDATE_TYPE_MIGRATE),
                ("stop", UPDATE_TYPE_DESTROY),
                ("canary", UPDATE_TYPE_CANARY),
                ("in_place_update", UPDATE_TYPE_INPLACE),
                ("destructive_update", UPDATE_TYPE_DESTRUCTIVE)):
            n = updates.get(src) or 0
            if n:
                out[label] = n
    _annotate_count_change(tg)
    for td in tg.get("Tasks") or []:
        _annotate_task(td, tg)


def _annotate_count_change(tg: Dict) -> None:
    """annotateCountChange:106."""
    count = next((f for f in tg.get("Fields") or []
                  if f.get("Name") == "count"), None)
    if count is None:
        return
    old = int(count.get("Old") or 0)
    new = int(count.get("New") or 0)
    if old < new:
        count.setdefault("Annotations", []).append(FORCES_CREATE)
    elif new < old:
        count.setdefault("Annotations", []).append(FORCES_DESTROY)


def _annotate_task(td: Dict, parent: Dict) -> None:
    """annotateTask:150."""
    if td.get("Type") == "None":
        return
    if parent.get("Type") in ("Added", "Deleted"):
        if td.get("Type") == "Added":
            td.setdefault("Annotations", []).append(FORCES_CREATE)
            return
        if td.get("Type") == "Deleted":
            td.setdefault("Annotations", []).append(FORCES_DESTROY)
            return
    destructive = any(
        f.get("Name") not in _NONDESTRUCTIVE_FIELDS
        for f in td.get("Fields") or [])
    if not destructive:
        destructive = any(
            not str(o.get("Name", "")).startswith(_INPLACE_OBJECTS)
            for o in td.get("Objects") or [])
    td.setdefault("Annotations", []).append(
        FORCES_DESTRUCTIVE if destructive else FORCES_INPLACE)
