"""The `job init` example jobspec (reference: command/assets/example.nomad,
adapted to the drivers available here)."""

EXAMPLE_JOB = '''# An example jobspec. Run it with:
#   python -m nomad_tpu_torch job run example.nomad
job "example" {
  datacenters = ["dc1"]
  type = "service"

  update {
    max_parallel      = 1
    min_healthy_time  = "10s"
    healthy_deadline  = "3m"
    progress_deadline = "10m"
    auto_revert       = false
    canary            = 0
  }

  group "cache" {
    count = 1

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
      driver = "mock_driver"

      config {
        run_for = "3600s"
      }

      resources {
        cpu    = 500
        memory = 256

        network {
          mbits = 10
          port "db" {}
        }
      }
    }
  }
}
'''
