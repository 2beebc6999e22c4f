"""The reference's API-surface tests (tests/test_api_surface.py) that run
no Client, against the port's event broker and job diff engine, their
assertions unchanged. The rest of the reference's file runs a Client on
its `cluster` fixture (ROADMAP queue 1 item 5).
"""

from nomad_tpu_torch import mock
from nomad_tpu_torch.server.event_broker import (
    EventBroker, Event, TOPIC_JOB, TOPIC_NODE,
)

import test_torch_select  # noqa: F401  (torch's thread cap)


def test_event_broker_topic_filtering():
    b = EventBroker()
    sub_all, _ = b.subscribe()
    sub_job, _ = b.subscribe({TOPIC_JOB: ["my-job"]})
    b.publish([Event(topic=TOPIC_JOB, type="JobRegistered", key="my-job",
                     index=5),
               Event(topic=TOPIC_JOB, type="JobRegistered", key="other",
                     index=6),
               Event(topic=TOPIC_NODE, type="NodeRegistration", key="n1",
                     index=7)])
    got_all = sub_all.next_events(timeout_s=1.0)
    assert len(got_all) == 3
    got_job = sub_job.next_events(timeout_s=1.0)
    assert [e.key for e in got_job] == ["my-job"]
    # replay: a late subscriber sees buffered events after from_index
    late, backlog = b.subscribe({TOPIC_JOB: ["*"]}, from_index=5)
    assert [e.key for e in backlog] == ["other"]
    late.unsubscribe()
    sub_all.unsubscribe()
    sub_job.unsubscribe()


def test_job_diff_engine():
    from nomad_tpu_torch.models.diff import job_diff, DIFF_ADDED, DIFF_EDITED
    old = mock.job()
    new = old.copy()
    new.priority = 70
    new.task_groups[0].count = 12
    new.task_groups[0].tasks[0].env = {"FOO": "baz", "NEW": "1"}
    d = job_diff(old, new)
    assert d["Type"] == DIFF_EDITED
    assert any(f["Name"] == "priority" and f["Old"] == "50"
               and f["New"] == "70" for f in d["Fields"])
    tg = [g for g in d["TaskGroups"] if g["Name"] == "web"][0]
    assert any(f["Name"] == "count" and f["New"] == "12"
               for f in tg["Fields"])
    task = tg["Tasks"][0]
    env_obj = [o for o in task["Objects"] if o["Name"] == "env"][0]
    names = {f["Name"]: f for f in env_obj["Fields"]}
    assert names["env[FOO]"]["Old"] == "bar"
    assert names["env[NEW]"]["Type"] == DIFF_ADDED

    # new job is all Added; identical jobs are None
    assert job_diff(None, old)["Type"] == DIFF_ADDED
    assert job_diff(old, old.copy())["Type"] == "None"
