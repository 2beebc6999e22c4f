"""The reference's jobspec tests (tests/test_jobspec.py) against the
port's jobspec/ (the HCL parser and parse_job onto the port's models),
their assertions unchanged.

The reference's docstring:

Jobspec parsing tests (reference patterns: jobspec/parse_test.go)."""

import pytest

from nomad_tpu_torch.jobspec import parse_hcl, parse_job, HclError
from nomad_tpu_torch.jobspec.parse import parse_duration_s

import test_torch_select  # noqa: F401  (torch's thread cap)

EXAMPLE = '''
# This is the "job init" example job (reference: command/assets/example.nomad)
job "example" {
  datacenters = ["dc1"]
  type = "service"

  update {
    max_parallel = 1
    min_healthy_time = "10s"
    healthy_deadline = "3m"
    progress_deadline = "10m"
    auto_revert = false
    canary = 0
  }
  migrate {
    max_parallel = 1
    min_healthy_time = "10s"
    healthy_deadline = "5m"
  }

  group "cache" {
    count = 3

    restart {
      attempts = 2
      interval = "30m"
      delay    = "15s"
      mode     = "fail"
    }

    ephemeral_disk {
      size = 300
    }

    task "redis" {
      driver = "raw_exec"

      config {
        command = "redis-server"
        args    = ["--port", "${NOMAD_PORT_db}"]
      }

      resources {
        cpu    = 500
        memory = 256

        network {
          mbits = 10
          port "db" {}
        }
      }

      service {
        name = "redis-cache"
        tags = ["global", "cache"]
        port = "db"

        check {
          name     = "alive"
          type     = "tcp"
          interval = "10s"
          timeout  = "2s"
        }
      }
    }
  }
}
'''


def test_parse_durations():
    assert parse_duration_s("30s") == 30.0
    assert parse_duration_s("500ms") == 0.5
    assert parse_duration_s("1h30m") == 5400.0
    assert parse_duration_s("10m") == 600.0
    assert parse_duration_s(42) == 42.0
    assert parse_duration_s(None, 7.0) == 7.0


def test_parse_hcl_basics():
    out = parse_hcl('a = 1\nb = "x"\nc = [1, 2, 3]\nd = true\n'
                    'blk "l1" { x = 2 }\n')
    assert out["a"] == 1
    assert out["b"] == "x"
    assert out["c"] == [1, 2, 3]
    assert out["d"] is True
    assert out["blk"]["l1"]["x"] == 2


def test_parse_hcl_repeated_blocks():
    out = parse_hcl('t "a" { x = 1 }\nt "b" { x = 2 }\nu { y = 1 }\nu { y = 2 }')
    assert out["t"]["a"]["x"] == 1
    assert out["t"]["b"]["x"] == 2
    assert [b["y"] for b in out["u"]] == [1, 2]


def test_parse_hcl_heredoc_and_comments():
    out = parse_hcl('x = <<EOF\nhello\nworld\nEOF\n// c1\n# c2\n/* c3 */\ny = 1')
    assert out["x"] == "hello\nworld\n"
    assert out["y"] == 1


def test_parse_hcl_errors():
    with pytest.raises(HclError):
        parse_hcl('x = ')
    with pytest.raises(HclError):
        parse_hcl('blk {')


def test_parse_example_job():
    job = parse_job(EXAMPLE)
    assert job.id == "example"
    assert job.type == "service"
    assert job.datacenters == ["dc1"]
    assert job.update.max_parallel == 1
    assert job.update.healthy_deadline_s == 180.0
    assert len(job.task_groups) == 1
    tg = job.task_groups[0]
    assert tg.name == "cache"
    assert tg.count == 3
    assert tg.restart_policy.attempts == 2
    assert tg.restart_policy.interval_s == 1800.0
    assert tg.ephemeral_disk.size_mb == 300
    assert tg.migrate.healthy_deadline_s == 300.0
    task = tg.tasks[0]
    assert task.name == "redis"
    assert task.driver == "raw_exec"
    assert task.config["command"] == "redis-server"
    assert task.resources.cpu == 500
    assert task.resources.memory_mb == 256
    nw = task.resources.networks[0]
    assert nw.mbits == 10
    assert nw.dynamic_ports[0].label == "db"
    svc = task.services[0]
    assert svc.name == "redis-cache"
    assert svc.checks[0].interval_s == 10.0
    # whole thing validates
    assert job.validate() == []


def test_parse_constraints_affinity_spread():
    src = '''
job "x" {
  datacenters = ["dc1"]
  constraint {
    attribute = "${attr.kernel.name}"
    value = "linux"
  }
  constraint {
    attribute = "${attr.cpu.version}"
    operator = ">="
    value = "6"
  }
  affinity {
    attribute = "${meta.rack}"
    value = "r1"
    weight = 70
  }
  spread {
    attribute = "${node.datacenter}"
    weight = 100
    target "dc1" { percent = 70 }
    target "dc2" { percent = 30 }
  }
  group "g" {
    task "t" {
      driver = "mock_driver"
      config { run_for = "1s" }
    }
  }
}
'''
    job = parse_job(src)
    assert job.constraints[0].ltarget == "${attr.kernel.name}"
    assert job.constraints[0].rtarget == "linux"
    assert job.constraints[1].operand == ">="
    assert job.affinities[0].weight == 70
    sp = job.spreads[0]
    assert sp.attribute == "${node.datacenter}"
    assert {t.value: t.percent for t in sp.spread_target} == \
        {"dc1": 70, "dc2": 30}
    assert job.task_groups[0].tasks[0].config["run_for"] == "1s"


def test_parse_json_jobspec():
    import json
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.jobspec import job_to_spec
    j = mock.batch_job()
    data = json.dumps({"job": job_to_spec(j)})
    j2 = parse_job(data)
    assert j2.id == j.id
    assert j2.type == "batch"
    assert j2.task_groups[0].tasks[0].driver == "mock_driver"


def test_static_port_parsing():
    src = '''
job "p" {
  datacenters = ["dc1"]
  group "g" {
    task "t" {
      driver = "mock_driver"
      config {}
      resources {
        network {
          port "http" { static = 8080 }
          port "dyn" {}
        }
      }
    }
  }
}
'''
    job = parse_job(src)
    nw = job.task_groups[0].tasks[0].resources.networks[0]
    assert nw.reserved_ports[0].label == "http"
    assert nw.reserved_ports[0].value == 8080
    assert nw.dynamic_ports[0].label == "dyn"
