"""The reference's device-attribute tests (tests/test_psstructs.py:
plugins/psstructs.py's Attribute parsing and comparison, and
scheduler/devices.py's group_satisfies) against the port's copies,
their assertions unchanged.
"""

from nomad_tpu_torch.models import NodeDevice, NodeDeviceResource, RequestedDevice
from nomad_tpu_torch.models.constraints import Constraint
from nomad_tpu_torch.plugins.psstructs import (Attribute, compare_values,
                                         parse_attribute)
from nomad_tpu_torch.scheduler.devices import group_satisfies


def test_parse_plain_values():
    assert parse_attribute("100").int_val == 100
    assert parse_attribute("-5").int_val == -5
    assert parse_attribute("1.5").float_val == 1.5
    assert parse_attribute("true").bool_val is True
    assert parse_attribute("F").bool_val is False
    assert parse_attribute("foo bar").str_val == "foo bar"
    assert parse_attribute("").str_val == ""


def test_parse_units_longest_suffix():
    a = parse_attribute("500 MiB")
    assert a.int_val == 500 and a.unit == "MiB"
    a = parse_attribute("1.250GHz")
    assert a.float_val == 1.25 and a.unit == "GHz"
    a = parse_attribute("100MB/s")
    assert a.int_val == 100 and a.unit == "MB/s"
    # Unknown trailing letters stay a string.
    assert parse_attribute("12 floops").str_val == "12 floops"


def test_cross_unit_comparison():
    # 1 GiB > 500 MiB; 1024 MiB == 1 GiB.
    assert compare_values("1 GiB", "500 MiB") == (1, True)
    assert compare_values("1024 MiB", "1 GiB") == (0, True)
    # Decimal vs binary: 1 GB (1e9) < 1 GiB (2^30).
    assert compare_values("1 GB", "1 GiB") == (-1, True)
    # Hertz: 1.5 GHz > 900 MHz.
    assert compare_values("1.5 GHz", "900 MHz") == (1, True)
    # Inverse multiplier: 250000 mW == 250 W < 1 kW.
    assert compare_values("250000 mW", "250 W") == (0, True)
    assert compare_values("250000 mW", "1 kW") == (-1, True)


def test_incomparable_dimensions():
    # Bytes vs byte-rates share multipliers but not dimensions.
    assert compare_values("1 MiB", "1 MiB/s")[1] is False
    # Unit vs unitless number.
    assert compare_values("1 MiB", "1048576")[1] is False
    # String vs number.
    assert compare_values("abc", "5")[1] is False


def test_bool_compares_equality_only():
    assert compare_values("true", "true") == (0, True)
    assert compare_values("true", "false") == (1, True)
    assert compare_values("true", "1 GiB")[1] is False


def test_exact_int_precision():
    # 2^60 + 1 vs 2^60 bytes must not collapse in float space.
    big = str((1 << 60) + 1)
    assert compare_values(big, str(1 << 60)) == (1, True)
    # 1 EiB == 2^60 B exactly.
    assert compare_values("1 EiB", str(1 << 60) + " B")[1] is False  # "B" alone is not a unit
    assert compare_values("1 EiB", "1048576 TiB") == (0, True)


def test_attribute_of_wraps_natives():
    assert Attribute.of(5).int_val == 5
    assert Attribute.of(True).bool_val is True
    assert Attribute.of(2.5).float_val == 2.5
    assert Attribute.of("16 GiB").unit == "GiB"
    assert Attribute.of(None) is None


def _group(**attrs):
    return NodeDeviceResource(
        vendor="nvidia", type="gpu", name="1080ti",
        attributes=attrs,
        instances=[NodeDevice(id="d0", healthy=True)])


def test_device_constraint_with_units():
    g = _group(memory="11441 MiB", bar1="256 MiB")
    req = RequestedDevice(
        name="gpu", count=1,
        constraints=[Constraint(ltarget="${device.attr.memory}",
                                operand=">=", rtarget="10 GiB")])
    assert group_satisfies(g, req)
    req.constraints[0].rtarget = "12 GiB"
    assert not group_satisfies(g, req)


def test_device_constraint_incomparable_fails():
    g = _group(memory="11441 MiB")
    req = RequestedDevice(
        name="gpu", count=1,
        constraints=[Constraint(ltarget="${device.attr.memory}",
                                operand=">=", rtarget="10 GiB/s")])
    assert not group_satisfies(g, req)


def test_device_constraint_not_with_missing_operand():
    # nil != some is true (feasible.go:1313).
    g = _group()
    req = RequestedDevice(
        name="gpu", count=1,
        constraints=[Constraint(ltarget="${device.attr.missing}",
                                operand="!=", rtarget="x")])
    assert group_satisfies(g, req)


def test_device_constraint_version_and_sets():
    g = _group(cuda="11.4.2", caps="fp16,int8,tf32")
    ok = RequestedDevice(
        name="gpu", count=1,
        constraints=[
            Constraint(ltarget="${device.attr.cuda}",
                       operand="version", rtarget=">= 11.0"),
            Constraint(ltarget="${device.attr.caps}",
                       operand="set_contains", rtarget="fp16,int8"),
        ])
    assert group_satisfies(g, ok)
    bad = RequestedDevice(
        name="gpu", count=1,
        constraints=[Constraint(ltarget="${device.attr.caps}",
                                operand="set_contains_any",
                                rtarget="fp64,bf16")])
    assert not group_satisfies(g, bad)
