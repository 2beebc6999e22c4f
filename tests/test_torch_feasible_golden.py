"""The port's run of tests/test_feasible_golden.py: its tests and assertions
over nomad_tpu_torch, on the CPU (the kernels' plain versions).

Golden feasibility scenarios ported from the reference — operand
tables and device-checker edge cases keep their source names
(scheduler/feasible_test.go). The scalar
Go checks become columnar assertions over single-node tables.
"""

import numpy as np
import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import Constraint
from nomad_tpu_torch.models.resources import (NodeDevice, NodeDeviceResource,
                                              RequestedDevice)
from nomad_tpu_torch.ops.targets import TargetColumns, constraint_mask
from nomad_tpu_torch.scheduler.devices import static_device_mask
from nomad_tpu_torch.utils.ids import generate_uuid


def _cols(attrs=None, meta=None):
    node = mock.node()
    node.attributes.update(attrs or {})
    node.meta.update(meta or {})
    return TargetColumns([node])


def _check(op, lval, rval):
    """checkConstraint over a one-node table: lval==None means the
    attribute is absent; rval is a literal rtarget."""
    attrs = {} if lval is None else {"probe": lval}
    cols = _cols(attrs)
    ltarget = "${attr.probe}"
    return bool(constraint_mask(cols, ltarget, rval or "", op)[0])


def test_CheckConstraint():
    """feasible_test.go:740 — the equality/inequality operand table
    including nil handling."""
    cases = [
        ("=", "foo", "foo", True),
        ("is", "foo", "foo", True),
        ("==", "foo", "foo", True),
        ("==", "foo", None, False),
        ("==", None, "foo", False),
        ("==", None, None, False),
        ("!=", "foo", "foo", False),
        ("!=", "foo", "bar", True),
        ("!=", None, "foo", True),
        ("!=", "foo", None, True),
        ("!=", None, None, False),
    ]
    for op, l, r, want in cases:
        # rtarget None == comparing against an absent attribute
        attrs = {}
        if l is not None:
            attrs["l"] = l
        if r is not None:
            attrs["r"] = r
        cols = _cols(attrs)
        got = bool(constraint_mask(cols, "${attr.l}", "${attr.r}", op)[0])
        assert got == want, (op, l, r)


def test_CheckConstraint_ordering_and_sets():
    """feasible_test.go:740 (cont.) — lexical ordering, is_set /
    is_not_set, set_contains."""
    assert _check("<", "abc", "lol") is True
    assert _check("<", "lol", "abc") is False
    assert _check("is_set", "yes", "") is True
    assert _check("is_set", None, "") is False
    assert _check("is_not_set", None, "") is True
    assert _check("is_not_set", "yes", "") is False
    assert _check("set_contains", "a,b,c", "a,c") is True
    assert _check("set_contains", "a,b,c", "a,d") is False
    assert _check("set_contains_any", "a,b,c", "x,c") is True
    assert _check("set_contains_any", "a,b,c", "x,y") is False


def test_CheckVersionConstraint():
    """feasible_test.go:917 — flexible version matching: pessimistic
    operator, ranges, prerelease handling, build metadata ignored."""
    cases = [
        ("1.2.3", "~> 1.0", True),
        ("1.2.3", ">= 1.0, < 1.4", True),
        ("2.0.1", "~> 1.0", False),
        ("1.4", ">= 1.0, < 1.4", False),
        ("1", "~> 1.0", True),
        # prereleases are never > final releases (go-version semantics)
        ("1.3.0-beta1", ">= 0.6.1", False),
        ("1.7.0-alpha1", ">= 1.6.0-beta1", False),
        # meta is ignored
        ("1.3.0-beta1+ent", "= 1.3.0-beta1", True),
    ]
    for lval, rval, want in cases:
        assert _check("version", lval, rval) == want, (lval, rval)


def test_CheckSemverConstraint():
    """feasible_test.go:970 — strict semver: no pessimistic operator,
    prereleases compare per semver §11."""
    cases = [
        ("1.2.3", "~> 1.0", False),      # pessimistic always fails
        ("1.2.3", ">= 1.0, < 1.4", True),
        ("2.0.1", "~> 1.0", False),
        ("1.4", ">= 1.0, < 1.4", False),
        ("1", "~> 1.0", False),
        ("1.3.0-beta1", ">= 0.6.1", True),
        ("1.7.0-alpha1", ">= 1.6.0-beta1", True),
        ("1.3.0-beta1+ent", "= 1.3.0-beta1", True),
    ]
    for lval, rval, want in cases:
        assert _check("semver", lval, rval) == want, (lval, rval)


def test_CheckRegexpConstraint():
    """feasible_test.go:1032 — regex matching incl. an invalid
    pattern failing closed."""
    assert _check("regexp", "foobar", "bar$") is True
    assert _check("regexp", "foobar", "^bar") is False
    assert _check("regexp", None, "foo") is False
    # invalid regex: fail closed, never raise
    assert _check("regexp", "foobar", "(unclosed") is False


def test_CheckAttributeConstraint_numeric_semantics():
    """feasible_test.go:2524 (subset) — numeric-looking strings still
    compare; missing attributes fail every comparison operand."""
    assert _check("==", "123", "123") is True
    assert _check("!=", "123", "124") is True
    assert _check(">", None, "1") is False
    assert _check("<", None, "1") is False


# -- TestDeviceChecker (feasible_test.go:2186) -------------------------

def _group(vendor="nvidia", typ="gpu", name="1080ti", healthy=2,
           unhealthy=0, attrs=None):
    instances = [NodeDevice(id=generate_uuid(), healthy=True)
                 for _ in range(healthy)]
    instances += [NodeDevice(id=generate_uuid(), healthy=False)
                  for _ in range(unhealthy)]
    return NodeDeviceResource(vendor=vendor, type=typ, name=name,
                              instances=instances,
                              attributes=dict(attrs or {}))


def _node_with(devices):
    node = mock.node()
    node.node_resources.devices = list(devices)
    return node


def _device_ok(devices, asks):
    return bool(static_device_mask([_node_with(devices)], asks)[0])


def test_DeviceChecker():
    """feasible_test.go:2186 — the name-form/health/count matrix."""
    nvidia = _group()
    nvidia_unhealthy = _group(healthy=0, unhealthy=2)
    cases = [
        ("no devices on node", False, [], [RequestedDevice("gpu", 1)]),
        ("no requested devices on empty node", True, [], []),
        ("gpu devices by type", True, [nvidia],
         [RequestedDevice("gpu", 1)]),
        ("wrong devices by type", False, [nvidia],
         [RequestedDevice("fpga", 1)]),
        ("devices by type unhealthy node", False, [nvidia_unhealthy],
         [RequestedDevice("gpu", 1)]),
        ("gpu devices by vendor/type", True, [nvidia],
         [RequestedDevice("nvidia/gpu", 1)]),
        ("wrong devices by vendor/type", False, [nvidia],
         [RequestedDevice("nvidia/fpga", 1)]),
        ("gpu devices by vendor/type/model", True, [nvidia],
         [RequestedDevice("nvidia/gpu/1080ti", 1)]),
        ("wrong devices by vendor/type/model", False, [nvidia],
         [RequestedDevice("nvidia/fpga/F100", 1)]),
        ("too many requested", False, [nvidia],
         [RequestedDevice("gpu", 3)]),
    ]
    for name, want, devices, asks in cases:
        assert _device_ok(devices, asks) == want, name


def test_DeviceChecker_constraints():
    """feasible_test.go:2186 (constraint cases) — device attribute
    constraints gate the group."""
    nvidia = _group(attrs={"memory": 4096, "cores_clock": 800})
    meets = RequestedDevice("nvidia/gpu", 1, constraints=[
        Constraint(ltarget="${device.attr.memory}", rtarget="2048",
                   operand=">=")])
    fails = RequestedDevice("nvidia/gpu", 1, constraints=[
        Constraint(ltarget="${device.attr.memory}", rtarget="8192",
                   operand=">=")])
    assert _device_ok([nvidia], [meets]) is True
    assert _device_ok([nvidia], [fails]) is False
