"""The reference's agent config tests (tests/test_agent_config.py)
against the port's cli/agent_config.py, their assertions unchanged.

The reference's docstring:

HCL agent config files (reference: command/agent/config.go load +
merge, flags win)."""

import argparse

from nomad_tpu_torch.cli.agent_config import apply_to_args, load_agent_config
from nomad_tpu_torch.cli.main import build_parser

import test_torch_select  # noqa: F401  (torch's thread cap)

HCL = """
data_dir   = "/tmp/nomad-data"
datacenter = "dc9"
ports { http = 5646  rpc = 5647 }
server {
  enabled        = true
  num_schedulers = 7
  acl_enabled    = true
  server_peers   = ["a:1", "b:2"]
}
client {
  enabled   = true
  servers   = ["a:1"]
  node_name = "from-file"
  alloc_dir = "/tmp/allocs"
  state_dir = "/tmp/state"
  meta { rack = "r9" }
}
"""


def test_load_and_merge(tmp_path):
    p = tmp_path / "agent.hcl"
    p.write_text(HCL)
    cfg = load_agent_config(str(p))
    assert cfg.server_enabled and cfg.client_enabled
    assert cfg.num_schedulers == 7
    assert cfg.http_port == 5646 and cfg.rpc_port == 5647
    assert cfg.server_peers == ["a:1", "b:2"]
    assert cfg.meta == {"rack": "r9"}

    args = build_parser().parse_args(["agent", "-config", str(p)])
    apply_to_args(cfg, args)
    assert args.server and args.client
    assert args.http_port == 5646
    assert args.num_schedulers == 7
    assert args.acl_enabled is True
    assert args.server_peers == "a:1,b:2"
    assert args.node_name == "from-file"
    assert args.alloc_dir_base == "/tmp/allocs"
    assert args.state_dir == "/tmp/state"
    assert args.datacenter == "dc9"


def test_cli_flags_win(tmp_path):
    p = tmp_path / "agent.hcl"
    p.write_text(HCL)
    cfg = load_agent_config(str(p))
    args = build_parser().parse_args(
        ["agent", "-config", str(p), "-http-port", "7777",
         "-num-schedulers", "1", "-node-name", "cli-name"])
    apply_to_args(cfg, args)
    assert args.http_port == 7777
    assert args.num_schedulers == 1
    assert args.node_name == "cli-name"
