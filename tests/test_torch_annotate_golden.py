"""The port's run of tests/test_annotate_golden.py: its tests and assertions
over nomad_tpu_torch, on the CPU (the kernels' plain versions).

Plan-diff annotation goldens, ported from
scheduler/annotate_test.go (scenarios keep their source test names;
field names are this codebase's snake_case diff labels). The end-to-end
test of the plan endpoint (test_plan_endpoint_carries_annotated_diff)
waits for the port of server/core.py."""

from nomad_tpu_torch.scheduler.annotate import (
    FORCES_CREATE,
    FORCES_DESTROY,
    FORCES_DESTRUCTIVE,
    FORCES_INPLACE,
    UPDATE_TYPE_CANARY,
    UPDATE_TYPE_CREATE,
    UPDATE_TYPE_DESTROY,
    UPDATE_TYPE_DESTRUCTIVE,
    UPDATE_TYPE_IGNORE,
    UPDATE_TYPE_INPLACE,
    UPDATE_TYPE_MIGRATE,
    _annotate_count_change,
    _annotate_task,
    _annotate_task_group,
    annotate,
)


def test_annotate_task_group_updates():
    # TestAnnotateTaskGroup_Updates (annotate_test.go:10)
    annotations = {"DesiredTGUpdates": {"foo": {
        "ignore": 1, "place": 2, "migrate": 3, "stop": 4,
        "in_place_update": 5, "destructive_update": 6, "canary": 7}}}
    tg = {"Type": "Edited", "Name": "foo"}
    _annotate_task_group(tg, annotations)
    assert tg["Updates"] == {
        UPDATE_TYPE_IGNORE: 1, UPDATE_TYPE_CREATE: 2,
        UPDATE_TYPE_MIGRATE: 3, UPDATE_TYPE_DESTROY: 4,
        UPDATE_TYPE_INPLACE: 5, UPDATE_TYPE_DESTRUCTIVE: 6,
        UPDATE_TYPE_CANARY: 7}


def test_annotate_count_change_non_edited():
    # TestAnnotateCountChange_NonEdited (annotate_test.go:52)
    tg = {}
    _annotate_count_change(tg)
    assert tg == {}


def test_annotate_count_change():
    # TestAnnotateCountChange (annotate_test.go:61)
    up = {"Type": "Edited", "Name": "count", "Old": "1", "New": "3"}
    down = {"Type": "Edited", "Name": "count", "Old": "3", "New": "1"}
    _annotate_count_change({"Type": "Edited", "Fields": [up]})
    assert up["Annotations"] == [FORCES_CREATE]
    _annotate_count_change({"Type": "Edited", "Fields": [down]})
    assert down["Annotations"] == [FORCES_DESTROY]


def test_annotate_task_non_edited():
    # TestAnnotateTask_NonEdited (annotate_test.go:102)
    td = {"Type": "None"}
    _annotate_task(td, {"Type": "None"})
    assert "Annotations" not in td


def test_annotate_task():
    # TestAnnotateTask (annotate_test.go:112) — the decision table
    cases = [
        # primitive field change -> destructive
        ({"Type": "Edited", "Fields": [
            {"Type": "Edited", "Name": "driver",
             "Old": "docker", "New": "exec"}]},
         {"Type": "Edited"}, FORCES_DESTRUCTIVE),
        ({"Type": "Edited", "Fields": [
            {"Type": "Edited", "Name": "user",
             "Old": "alice", "New": "bob"}]},
         {"Type": "Edited"}, FORCES_DESTRUCTIVE),
        # KillTimeout is the one in-place primitive
        ({"Type": "Edited", "Fields": [
            {"Type": "Edited", "Name": "kill_timeout_s",
             "Old": "5", "New": "7"}]},
         {"Type": "Edited"}, FORCES_INPLACE),
        # in-place object changes: log config, services, constraints
        ({"Type": "Edited", "Objects": [
            {"Type": "Edited", "Name": "log_config"}]},
         {"Type": "Edited"}, FORCES_INPLACE),
        ({"Type": "Edited", "Objects": [
            {"Type": "Edited", "Name": "services[web]"}]},
         {"Type": "Edited"}, FORCES_INPLACE),
        ({"Type": "Edited", "Objects": [
            {"Type": "Edited", "Name": "constraints"}]},
         {"Type": "Edited"}, FORCES_INPLACE),
        # any other object change -> destructive
        ({"Type": "Edited", "Objects": [
            {"Type": "Edited", "Name": "templates"}]},
         {"Type": "Edited"}, FORCES_DESTRUCTIVE),
        # whole group added/deleted dominates
        ({"Type": "Added"}, {"Type": "Added"}, FORCES_CREATE),
        ({"Type": "Deleted"}, {"Type": "Deleted"}, FORCES_DESTROY),
    ]
    for td, parent, want in cases:
        _annotate_task(td, parent)
        assert td["Annotations"] == [want], (td, want)


def test_annotate_noop_without_groups():
    assert annotate({"TaskGroups": []}) == {"TaskGroups": []}
