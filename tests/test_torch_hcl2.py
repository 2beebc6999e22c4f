"""The reference's HCL2 tests (tests/test_hcl2.py) against the port's
jobspec/hcl2.py (variables, functions, dynamic blocks), their
assertions unchanged.

The reference's docstring:

HCL2 jobspec evaluation: variables, locals, functions, expressions,
dynamic blocks (reference: jobspec2/parse.go, jobspec2/functions.go).
"""

import pytest

from nomad_tpu_torch.jobspec import parse_job
from nomad_tpu_torch.jobspec.hcl import parse_hcl
from nomad_tpu_torch.jobspec.hcl2 import (Hcl2Error, eval_expr, evaluate,
                                          interpolate_value)

import test_torch_select  # noqa: F401  (torch's thread cap)


# -- expressions -------------------------------------------------------
def test_expression_basics():
    scope = {"var": {"n": 3, "name": "web", "list": [1, 2, 3],
                     "map": {"a": "x"}}}
    assert eval_expr("var.n + 2", scope) == 5
    assert eval_expr("var.n * 2 - 1", scope) == 5
    assert eval_expr('var.name == "web"', scope) is True
    assert eval_expr("var.n > 2 && var.n < 10", scope) is True
    assert eval_expr('var.n > 5 ? "big" : "small"', scope) == "small"
    assert eval_expr("var.list[1]", scope) == 2
    assert eval_expr('var.map["a"]', scope) == "x"
    assert eval_expr("!false", scope) is True
    assert eval_expr("[1, 2, var.n]", scope) == [1, 2, 3]


def test_functions():
    scope = {"var": {"xs": ["c", "a", "b"], "s": " hi "}}
    assert eval_expr('upper("abc")', scope) == "ABC"
    assert eval_expr("length(var.xs)", scope) == 3
    assert eval_expr('join("-", var.xs)', scope) == "c-a-b"
    assert eval_expr("sort(var.xs)", scope) == ["a", "b", "c"]
    assert eval_expr("trimspace(var.s)", scope) == "hi"
    assert eval_expr('format("x-%s-%d", "a", 2)', scope) == "x-a-2"
    assert eval_expr('contains(var.xs, "a")', scope) is True
    assert eval_expr("max(1, 5, 3)", scope) == 5
    assert eval_expr('coalesce("", null, "z")', scope) == "z"
    assert eval_expr('element(var.xs, 4)', scope) == "a"
    assert eval_expr('jsonencode([1,2])', scope) == "[1, 2]"
    assert eval_expr('range(3)', scope) == [0, 1, 2]
    with pytest.raises(Hcl2Error, match="unknown function"):
        eval_expr("no_such_fn(1)", scope)


def test_interpolation_typing_and_runtime_passthrough():
    scope = {"var": {"n": 4, "name": "db"}}
    # full-expression strings keep their type (cty semantics)
    assert interpolate_value("${var.n}", scope) == 4
    # mixed text stringifies
    assert interpolate_value("n=${var.n}!", scope) == "n=4!"
    # runtime interpolations survive untouched
    assert interpolate_value("${node.datacenter}", scope) == \
        "${node.datacenter}"
    assert interpolate_value("${attr.cpu.arch}-${var.name}", scope) == \
        "${attr.cpu.arch}-db"
    assert interpolate_value("${NOMAD_TASK_NAME}", scope) == \
        "${NOMAD_TASK_NAME}"


# -- variables + locals ------------------------------------------------
HCL_VARS = """
variable "count" { default = 2 }
variable "image" {}
locals {
  full_image = "${var.image}:latest"
}
job "demo" {
  datacenters = ["dc1"]
  group "g" {
    count = var.count
    task "t" {
      driver = "mock_driver"
      config {
        image = local.full_image
        n     = "${var.count * 10}"
      }
    }
  }
}
"""


def test_variables_and_locals_end_to_end():
    job = parse_job(HCL_VARS, variables={"image": "redis"})
    assert job.task_groups[0].count == 2
    task = job.task_groups[0].tasks[0]
    assert task.config["image"] == "redis:latest"
    assert task.config["n"] == 20


def test_variable_override_and_missing():
    job = parse_job(HCL_VARS, variables={"image": "x", "count": 5})
    assert job.task_groups[0].count == 5
    with pytest.raises(Hcl2Error, match="missing value"):
        parse_job(HCL_VARS)
    with pytest.raises(Hcl2Error, match="undeclared"):
        parse_job(HCL_VARS, variables={"image": "x", "bogus": 1})


# -- dynamic blocks ----------------------------------------------------
def test_dynamic_blocks_unlabeled():
    src = """
variable "ports" { default = [8080, 9090] }
config {
  dynamic "check" {
    for_each = var.ports
    content {
      port = check.value
      idx  = "${check.key}"
    }
  }
}
"""
    out = evaluate(parse_hcl(src), None)
    checks = out["config"]["check"]
    assert [c["port"] for c in checks] == [8080, 9090]
    assert [c["idx"] for c in checks] == [0, 1]


def test_dynamic_blocks_labeled_tasks():
    src = """
variable "names" { default = ["a", "b"] }
job "multi" {
  datacenters = ["dc1"]
  group "g" {
    dynamic "task" {
      for_each = var.names
      labels   = ["worker-${task.value}"]
      content {
        driver = "mock_driver"
        config { run_for = "1s" }
      }
    }
  }
}
"""
    job = parse_job(src)
    names = sorted(t.name for t in job.task_groups[0].tasks)
    assert names == ["worker-a", "worker-b"]
