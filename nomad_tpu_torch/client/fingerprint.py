"""Cloud environment fingerprints: AWS / GCE / Azure metadata probes.

Reference semantics: client/fingerprint/env_aws.go, env_gce.go,
env_azure.go — each probes the platform's link-local metadata service
with a short timeout; a node not on that platform fails the probe fast
and carries no attributes. Attribute names mirror the reference
(`platform.aws.instance-type`, `unique.platform.aws.hostname`, ...)
and the node link (`aws.ec2`, `gce`, `azure`) feeds constraint
targeting just like any other attribute.

The metadata base URLs are arguments (`base_url`, and the `urls` of
fingerprint_cloud, which a client takes from
`ClientConfig.cloud_metadata_urls`), so tests point them at a fake local
HTTP server — the hook the reference exposes through AWS_ENV_URL /
GCE_ENV_URL (env_aws.go:37). No URL is read from the environment.
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request
from typing import Dict, Optional, Tuple

LOG = logging.getLogger("nomad_tpu.fingerprint")

DEFAULT_TIMEOUT_S = 0.5

AWS_METADATA_URL = "http://169.254.169.254/latest/meta-data/"
GCE_METADATA_URL = "http://169.254.169.254/computeMetadata/v1/"
AZURE_METADATA_URL = ("http://169.254.169.254/metadata/instance/"
                      "compute")
AZURE_API_VERSION = "2019-06-04"


def _get(url: str, headers: Optional[Dict[str, str]] = None,
         timeout_s: float = DEFAULT_TIMEOUT_S,
         method: str = "GET") -> Optional[str]:
    req = urllib.request.Request(url, headers=headers or {},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            return r.read().decode("utf-8", "replace")
    except Exception:
        return None


class AwsFingerprint:
    """env_aws.go: EC2 instance metadata v1 paths -> platform.aws.*"""

    name = "env_aws"
    platform = "aws"
    # metadata path -> attribute suffix; unique marks per-node identity
    # attributes (env_aws.go ec2InstanceSpeedMap sibling table)
    PATHS = (
        ("ami-id", "ami-id", False),
        ("hostname", "hostname", True),
        ("instance-id", "instance-id", True),
        ("instance-type", "instance-type", False),
        ("local-hostname", "local-hostname", True),
        ("local-ipv4", "local-ipv4", True),
        ("public-hostname", "public-hostname", True),
        ("public-ipv4", "public-ipv4", True),
        ("placement/availability-zone", "placement.availability-zone",
         False),
    )

    def __init__(self, base_url: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.base_url = base_url or AWS_METADATA_URL
        self.timeout_s = timeout_s

    def _session_headers(self) -> Dict[str, str]:
        """IMDSv2 session token (PUT /latest/api/token) — required by
        default on new EC2 launches and commonly enforced org-wide;
        without it every metadata GET 401s and the probe would
        silently report 'not on EC2'. A failed token request falls
        back to bare IMDSv1 headers."""
        token_url = self.base_url.replace("/meta-data/", "/api/token")
        if token_url == self.base_url:      # unexpected base: skip v2
            return {}
        token = _get(token_url, method="PUT", headers={
            "X-aws-ec2-metadata-token-ttl-seconds": "21600"},
            timeout_s=self.timeout_s)
        if token:
            return {"X-aws-ec2-metadata-token": token.strip()}
        return {}

    def fingerprint(self) -> Tuple[Dict[str, str], Dict[str, str]]:
        headers = self._session_headers()
        # availability probe first: one fast miss means "not on EC2";
        # a hit doubles as the ami-id value (no second round trip)
        probe = _get(self.base_url + "ami-id", headers=headers,
                     timeout_s=self.timeout_s)
        if probe is None:
            return {}, {}
        attrs: Dict[str, str] = {"platform.aws": "true"}
        for path, suffix, unique in self.PATHS:
            v = probe if path == "ami-id" else \
                _get(self.base_url + path, headers=headers,
                     timeout_s=self.timeout_s)
            if v is None or v == "":
                continue
            key = f"platform.aws.{suffix}"
            if unique:
                key = f"unique.{key}"
            attrs[key] = v.strip()
        links: Dict[str, str] = {}
        instance = attrs.get("unique.platform.aws.instance-id")
        az = attrs.get("platform.aws.placement.availability-zone")
        if instance and az:
            links["aws.ec2"] = f"{az}.{instance}"
        return attrs, links


class GceFingerprint:
    """env_gce.go: GCE metadata (Metadata-Flavor header) ->
    platform.gce.*"""

    name = "env_gce"
    platform = "gce"
    HEADERS = {"Metadata-Flavor": "Google"}
    PATHS = (
        ("instance/id", "id", True),
        ("instance/hostname", "hostname", True),
        ("instance/machine-type", "machine-type", False),
        ("instance/zone", "zone", False),
    )

    def __init__(self, base_url: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.base_url = base_url or GCE_METADATA_URL
        self.timeout_s = timeout_s

    def fingerprint(self) -> Tuple[Dict[str, str], Dict[str, str]]:
        probe = _get(self.base_url + "instance/id",
                     headers=self.HEADERS, timeout_s=self.timeout_s)
        if probe is None:
            return {}, {}
        attrs: Dict[str, str] = {"platform.gce": "true"}
        for path, suffix, unique in self.PATHS:
            v = probe if path == "instance/id" else \
                _get(self.base_url + path, headers=self.HEADERS,
                     timeout_s=self.timeout_s)
            if v is None or v == "":
                continue
            # machine-type/zone arrive as full resource paths
            # (projects/123/zones/us-central1-a); keep the leaf
            v = v.strip()
            if suffix in ("machine-type", "zone") and "/" in v:
                v = v.rsplit("/", 1)[1]
            key = f"platform.gce.{suffix}"
            if unique:
                key = f"unique.{key}"
            attrs[key] = v
        links: Dict[str, str] = {}
        if "unique.platform.gce.id" in attrs:
            links["gce"] = attrs["unique.platform.gce.id"]
        return attrs, links


class AzureFingerprint:
    """env_azure.go: IMDS compute document (Metadata: true header) ->
    platform.azure.*"""

    name = "env_azure"
    platform = "azure"
    HEADERS = {"Metadata": "true"}
    FIELDS = (
        ("name", "name", True),
        ("vmId", "id", True),
        ("vmSize", "vm-size", False),
        ("location", "location", False),
        ("resourceGroupName", "resource-group", False),
    )

    def __init__(self, base_url: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.base_url = base_url or AZURE_METADATA_URL
        self.timeout_s = timeout_s

    def fingerprint(self) -> Tuple[Dict[str, str], Dict[str, str]]:
        raw = _get(f"{self.base_url}?api-version={AZURE_API_VERSION}"
                   "&format=json", headers=self.HEADERS,
                   timeout_s=self.timeout_s)
        if raw is None:
            return {}, {}
        try:
            doc = json.loads(raw)
        except ValueError:
            return {}, {}
        attrs: Dict[str, str] = {"platform.azure": "true"}
        for field, suffix, unique in self.FIELDS:
            v = doc.get(field)
            if not v:
                continue
            key = f"platform.azure.{suffix}"
            if unique:
                key = f"unique.{key}"
            attrs[key] = str(v)
        links: Dict[str, str] = {}
        if "unique.platform.azure.id" in attrs:
            links["azure"] = attrs["unique.platform.azure.id"]
        return attrs, links


CLOUD_FINGERPRINTERS = (AwsFingerprint, GceFingerprint,
                        AzureFingerprint)


def fingerprint_cloud(timeout_s: float = DEFAULT_TIMEOUT_S,
                      urls: Optional[Dict[str, str]] = None
                      ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """Run every cloud probe; a node is on at most one platform, so
    misses are cheap (one timed-out request each) and hits merge their
    attributes and links. `urls` maps a probe's platform ("aws", "gce",
    "azure") to the metadata base URL it asks in place of its
    default."""
    attrs: Dict[str, str] = {}
    links: Dict[str, str] = {}
    urls = urls or {}
    for cls in CLOUD_FINGERPRINTERS:
        try:
            a, l = cls(base_url=urls.get(cls.platform),
                       timeout_s=timeout_s).fingerprint()
        except Exception:       # pragma: no cover — defensive
            LOG.exception("cloud fingerprint %s failed", cls.name)
            continue
        attrs.update(a)
        links.update(l)
    return attrs, links
