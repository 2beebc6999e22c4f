"""Agent configuration files (reference: command/agent/config.go —
HCL config files merged under CLI flags; flags win).

Shape:

    data_dir   = "/var/lib/nomad-tpu"
    datacenter = "dc1"
    ports { http = 4646  rpc = 4647 }
    server {
      enabled        = true
      num_schedulers = 4
      acl_enabled    = true
      server_peers   = ["10.0.0.1:4647", "10.0.0.2:4647"]
    }
    client {
      enabled   = true
      servers   = ["10.0.0.1:4647"]
      node_name = "worker-1"
      alloc_dir = "/var/lib/nomad-tpu/allocs"
      state_dir = "/var/lib/nomad-tpu/client"
      meta { rack = "r1" }
    }
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class AgentFileConfig:
    data_dir: str = ""
    datacenter: str = ""
    region: str = ""
    region_peers: dict = field(default_factory=dict)
    http_port: Optional[int] = None
    rpc_port: Optional[int] = None
    server_enabled: bool = False
    client_enabled: bool = False
    num_schedulers: Optional[int] = None
    acl_enabled: Optional[bool] = None
    server_peers: List[str] = field(default_factory=list)
    authoritative_region: str = ""
    replication_token: str = ""
    servers: List[str] = field(default_factory=list)
    node_name: str = ""
    alloc_dir: str = ""
    state_dir: str = ""
    meta: dict = field(default_factory=dict)
    cloud_fingerprint: Optional[bool] = None


def load_agent_config(path: str) -> AgentFileConfig:
    from ..jobspec.hcl import parse_hcl
    with open(path) as f:
        data = parse_hcl(f.read())
    cfg = AgentFileConfig()
    cfg.data_dir = data.get("data_dir", "")
    cfg.datacenter = data.get("datacenter", "")
    cfg.region = data.get("region", "")
    # federation peers (the reference discovers these via WAN serf;
    # here they're configured): region_peers { west = "host:4646" }
    peers = data.get("region_peers") or {}
    if isinstance(peers, list):
        peers = peers[0]
    cfg.region_peers = {str(k): str(v) for k, v in peers.items()}
    ports = data.get("ports") or {}
    if isinstance(ports, list):
        ports = ports[0]
    if "http" in ports:
        cfg.http_port = int(ports["http"])
    if "rpc" in ports:
        cfg.rpc_port = int(ports["rpc"])
    srv = data.get("server") or {}
    if isinstance(srv, list):
        srv = srv[0]
    if srv:
        cfg.server_enabled = bool(srv.get("enabled", True))
        if "num_schedulers" in srv:
            cfg.num_schedulers = int(srv["num_schedulers"])
        if "acl_enabled" in srv:
            cfg.acl_enabled = bool(srv["acl_enabled"])
        cfg.server_peers = list(srv.get("server_peers", []))
        cfg.authoritative_region = srv.get("authoritative_region", "")
        cfg.replication_token = srv.get("replication_token", "")
    cli = data.get("client") or {}
    if isinstance(cli, list):
        cli = cli[0]
    if cli:
        cfg.client_enabled = bool(cli.get("enabled", True))
        cfg.servers = list(cli.get("servers", []))
        cfg.node_name = cli.get("node_name", "")
        cfg.alloc_dir = cli.get("alloc_dir", "")
        cfg.state_dir = cli.get("state_dir", "")
        cfg.meta = dict(cli.get("meta", {}))
        if "cloud_fingerprint" in cli:
            cfg.cloud_fingerprint = bool(cli["cloud_fingerprint"])
    return cfg


def apply_to_args(cfg: AgentFileConfig, args) -> None:
    """File values fill in; explicit CLI flags win (config.go Merge —
    argparse defaults are recognizable, so only defaults get
    overridden)."""
    if cfg.server_enabled and not (args.dev or args.server):
        args.server = True
    if cfg.client_enabled and not (args.dev or args.client):
        args.client = True
    if cfg.http_port is not None and args.http_port == 4646:
        args.http_port = cfg.http_port
    if cfg.rpc_port is not None and args.rpc_port == 4647:
        args.rpc_port = cfg.rpc_port
    if cfg.num_schedulers is not None and args.num_schedulers == 2:
        args.num_schedulers = cfg.num_schedulers
    if cfg.acl_enabled is not None and not args.acl_enabled:
        args.acl_enabled = cfg.acl_enabled
    if cfg.server_peers and not args.server_peers:
        args.server_peers = ",".join(cfg.server_peers)
    if cfg.servers and not args.servers:
        args.servers = ",".join(cfg.servers)
    if cfg.node_name and not args.node_name:
        args.node_name = cfg.node_name
    if cfg.alloc_dir and not args.alloc_dir_base:
        args.alloc_dir_base = cfg.alloc_dir
    if cfg.state_dir and not getattr(args, "state_dir", ""):
        args.state_dir = cfg.state_dir
    if cfg.data_dir and not getattr(args, "data_dir", ""):
        args.data_dir = cfg.data_dir
    if cfg.datacenter and not getattr(args, "datacenter", ""):
        args.datacenter = cfg.datacenter
    if cfg.region and not getattr(args, "region", ""):
        args.region = cfg.region
    if cfg.region_peers and not getattr(args, "region_peers", None):
        args.region_peers = [f"{k}={v}" for k, v in
                             cfg.region_peers.items()]
    if cfg.authoritative_region and \
            not getattr(args, "authoritative_region", ""):
        args.authoritative_region = cfg.authoritative_region
    if cfg.replication_token and \
            not getattr(args, "replication_token", ""):
        args.replication_token = cfg.replication_token
    if cfg.meta:
        args.client_meta = cfg.meta
    if cfg.cloud_fingerprint is not None and \
            not getattr(args, "cloud_fingerprint", False):
        args.cloud_fingerprint = cfg.cloud_fingerprint
