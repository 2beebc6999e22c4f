"""The reference's fingerprint_cloud suite (tests/test_fingerprint_cloud.py)
against the port's client/fingerprint.py, assertions unchanged.

Mapped: the port reads no metadata URL from the environment, so where
the reference sets NOMAD_AWS_METADATA_URL and its siblings the port's
copy passes them to fingerprint_cloud(urls=...) and to
ClientConfig(cloud_metadata_urls=...); the probes it does not point at
the fake server go to a local port where nothing listens. The server has
no governor (governor_enabled is not a setting of the port's).

The reference's docstring:

Cloud environment fingerprint tests (reference patterns:
client/fingerprint/env_aws_test.go with its httptest metadata server,
env_gce_test.go, env_azure_test.go) — a fake local HTTP server plays
the 169.254.169.254 metadata service."""

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.server import Server as _Server
from nomad_tpu_torch.client.fingerprint import (AwsFingerprint,
                                          AzureFingerprint,
                                          GceFingerprint,
                                          fingerprint_cloud)

AWS_PATHS = {
    "/latest/meta-data/ami-id": "ami-1234",
    "/latest/meta-data/hostname": "ip-10-0-0-207.ec2.internal",
    "/latest/meta-data/instance-id": "i-b3ba3875",
    "/latest/meta-data/instance-type": "m3.large",
    "/latest/meta-data/local-hostname": "ip-10-0-0-207.ec2.internal",
    "/latest/meta-data/local-ipv4": "10.0.0.207",
    "/latest/meta-data/public-hostname":
        "ec2-54-77-11-84.compute-1.amazonaws.com",
    "/latest/meta-data/public-ipv4": "54.77.11.84",
    "/latest/meta-data/placement/availability-zone": "us-west-2a",
}

GCE_PATHS = {
    "/computeMetadata/v1/instance/id": "12345678901234",
    "/computeMetadata/v1/instance/hostname":
        "instance-1.c.project.internal",
    "/computeMetadata/v1/instance/machine-type":
        "projects/1234/machineTypes/n1-standard-2",
    "/computeMetadata/v1/instance/zone":
        "projects/1234/zones/us-central1-f",
}

AZURE_DOC = {
    "name": "demo-vm", "vmId": "13f56399-bd52-4150-9748-7190aae1ff21",
    "vmSize": "Standard_DS2", "location": "westus",
    "resourceGroupName": "demo-rg",
}


IMDS_TOKEN = "fake-imdsv2-token"


def Server(config=None, **kw):
    # the port's Server on the CPU: the kernels' plain versions
    return _Server(config, device="cpu", **kw)


class _Handler(BaseHTTPRequestHandler):
    # when True, AWS metadata GETs 401 without the IMDSv2 session
    # token — the default posture of newly launched EC2 instances
    imdsv2_required = False

    def log_message(self, *a):   # quiet
        pass

    def do_PUT(self):
        if self.path.split("?", 1)[0] == "/latest/api/token" and \
                self.headers.get("X-aws-ec2-metadata-token-ttl-seconds"):
            body = IMDS_TOKEN.encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.send_response(404)
        self.end_headers()

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        if type(self).imdsv2_required and path.startswith("/latest/") \
                and self.headers.get("X-aws-ec2-metadata-token") != \
                IMDS_TOKEN:
            self.send_response(401)
            self.end_headers()
            return
        # GCE requires its flavor header (env_gce.go checkError)
        if path.startswith("/computeMetadata/") and \
                self.headers.get("Metadata-Flavor") != "Google":
            self.send_response(403)
            self.end_headers()
            return
        if path.startswith("/metadata/instance/compute"):
            if self.headers.get("Metadata") != "true":
                self.send_response(403)
                self.end_headers()
                return
            body = json.dumps(AZURE_DOC).encode()
        elif path in AWS_PATHS:
            body = AWS_PATHS[path].encode()
        elif path in GCE_PATHS:
            body = GCE_PATHS[path].encode()
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture(scope="module")
def metadata_server():
    srv = HTTPServer(("127.0.0.1", 0), _Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()


def test_aws_fingerprint(metadata_server):
    fp = AwsFingerprint(base_url=f"{metadata_server}/latest/meta-data/")
    attrs, links = fp.fingerprint()
    assert attrs["platform.aws"] == "true"
    assert attrs["platform.aws.instance-type"] == "m3.large"
    assert attrs["unique.platform.aws.instance-id"] == "i-b3ba3875"
    assert attrs["unique.platform.aws.local-ipv4"] == "10.0.0.207"
    assert attrs["platform.aws.placement.availability-zone"] == \
        "us-west-2a"
    assert links["aws.ec2"] == "us-west-2a.i-b3ba3875"


def test_aws_fingerprint_imdsv2_required(metadata_server):
    """With HttpTokens=required (the modern EC2 default) tokenless
    GETs 401: the probe must negotiate an IMDSv2 session token rather
    than silently reporting 'not on EC2'."""
    _Handler.imdsv2_required = True
    try:
        fp = AwsFingerprint(
            base_url=f"{metadata_server}/latest/meta-data/")
        attrs, links = fp.fingerprint()
        assert attrs["platform.aws"] == "true"
        assert attrs["unique.platform.aws.instance-id"] == "i-b3ba3875"
        assert links["aws.ec2"] == "us-west-2a.i-b3ba3875"
    finally:
        _Handler.imdsv2_required = False


def test_gce_fingerprint(metadata_server):
    fp = GceFingerprint(
        base_url=f"{metadata_server}/computeMetadata/v1/")
    attrs, links = fp.fingerprint()
    assert attrs["platform.gce"] == "true"
    # resource paths reduced to their leaf
    assert attrs["platform.gce.machine-type"] == "n1-standard-2"
    assert attrs["platform.gce.zone"] == "us-central1-f"
    assert links["gce"] == "12345678901234"


def test_azure_fingerprint(metadata_server):
    fp = AzureFingerprint(
        base_url=f"{metadata_server}/metadata/instance/compute")
    attrs, links = fp.fingerprint()
    assert attrs["platform.azure"] == "true"
    assert attrs["platform.azure.vm-size"] == "Standard_DS2"
    assert attrs["unique.platform.azure.name"] == "demo-vm"
    assert links["azure"] == AZURE_DOC["vmId"]


def test_absent_platform_probes_empty():
    # nothing listening: every probe fails fast and quietly
    fp = AwsFingerprint(base_url="http://127.0.0.1:9/latest/meta-data/",
                        timeout_s=0.1)
    assert fp.fingerprint() == ({}, {})


def test_fingerprint_cloud_merges(metadata_server):
    attrs, links = fingerprint_cloud(urls={
        "aws": f"{metadata_server}/latest/meta-data/",
        "gce": f"{metadata_server}/computeMetadata/v1/",
        "azure": f"{metadata_server}/metadata/instance/compute"})
    assert attrs["platform.aws"] == "true"
    assert attrs["platform.gce"] == "true"
    assert attrs["platform.azure"] == "true"
    assert set(links) == {"aws.ec2", "gce", "azure"}


def test_agent_node_carries_cloud_attributes(metadata_server):
    """End-to-end §2.3: a client agent with cloud_fingerprint enabled
    registers a node whose attributes/links carry the platform probe
    results (usable as constraint targets)."""
    from nomad_tpu_torch.client import Client, ClientConfig
    from nomad_tpu_torch.server import ServerConfig
    server = Server(ServerConfig(num_schedulers=0))
    server.establish_leadership()
    client = Client(server, ClientConfig(
        node_name="cloudy", cloud_fingerprint=True, rpc_port=None,
        cloud_metadata_urls={
            "aws": f"{metadata_server}/latest/meta-data/",
            # nothing listens there: the probes miss fast, as off a
            # cloud
            "gce": "http://127.0.0.1:9/computeMetadata/v1/",
            "azure": "http://127.0.0.1:9/metadata/instance/compute"}))
    try:
        node = client.node
        assert node.attributes["platform.aws"] == "true"
        assert node.attributes["unique.platform.aws.instance-id"] == \
            "i-b3ba3875"
        assert node.links["aws.ec2"] == "us-west-2a.i-b3ba3875"
    finally:
        server.shutdown()
