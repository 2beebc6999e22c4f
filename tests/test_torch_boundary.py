"""The port's boundary: nomad_tpu_torch and chip_smoke.py import neither JAX
nor anything of nomad_tpu, and the port never runs on the CPU unless it
is asked to."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

PLACE_ONE_JOB = r"""
import sys
sys.modules["jax"] = None
sys.modules["nomad_tpu"] = None
from nomad_tpu_torch import mock
from nomad_tpu_torch.models import (Evaluation, EVAL_STATUS_PENDING,
                                    TRIGGER_JOB_REGISTER)
from nomad_tpu_torch.scheduler.harness import Harness
h = Harness(device="cpu")
for i in range(8):
    h.store.upsert_node(h.next_index(), mock.node())
job = mock.job()
h.store.upsert_job(h.next_index(), job)
h.process("service", Evaluation(
    id="e1", namespace=job.namespace, priority=job.priority,
    triggered_by=TRIGGER_JOB_REGISTER, job_id=job.id,
    status=EVAL_STATUS_PENDING, type=job.type))
placed = h.store.allocs_by_job(job.namespace, job.id)
assert h.evals[-1].status == "complete", h.evals[-1].status
assert len(placed) == 10, len(placed)
# two lanes on one snapshot through the batched arm's gateway
import threading
from nomad_tpu_torch.ops.select import SelectKernel
from nomad_tpu_torch.scheduler import new_scheduler
from nomad_tpu_torch.server import BatchGateway
lane_jobs = []
for i in range(2):
    lj = mock.job()
    lj.id = lj.name = f"lane-{i}"
    lj.task_groups[0].count = 2
    h.store.upsert_job(h.next_index(), lj)
    lane_jobs.append(lj)
snap = h.store.snapshot()
gw = BatchGateway(SelectKernel("cpu"), lanes=2, partition=False)
gw.window_s = 60.0
def lane(lj):
    try:
        sched = new_scheduler("service", snap, h)
        sched.kernel_dispatch = gw.dispatch
        sched.process(Evaluation(
            id=f"e-{lj.id}", namespace=lj.namespace, priority=lj.priority,
            triggered_by=TRIGGER_JOB_REGISTER, job_id=lj.id,
            status=EVAL_STATUS_PENDING, type=lj.type))
    finally:
        gw.lane_finished()
threads = [threading.Thread(target=lane, args=(lj,)) for lj in lane_jobs]
for t in threads:
    t.start()
for t in threads:
    t.join(120)
assert gw.stats["batches"] == 1, gw.stats
for lj in lane_jobs:
    assert len(h.store.allocs_by_job(lj.namespace, lj.id)) == 2, lj.id
# one more job over a CPU mesh of 8 shards (the node-sharded path)
from nomad_tpu_torch.ops.select import mesh_stats_snapshot, set_mesh
from nomad_tpu_torch.parallel import make_mesh
set_mesh(make_mesh(8, "cpu"))
mj = mock.job()
mj.id = mj.name = "meshed"
h.store.upsert_job(h.next_index(), mj)
h.process("service", Evaluation(
    id="e-meshed", namespace=mj.namespace, priority=mj.priority,
    triggered_by=TRIGGER_JOB_REGISTER, job_id=mj.id,
    status=EVAL_STATUS_PENDING, type=mj.type))
assert len(h.store.allocs_by_job(mj.namespace, mj.id)) == 10
assert mesh_stats_snapshot()["reshard_uploads"] == 1
set_mesh(None)
bad = [m for m, mod in sys.modules.items() if mod is not None and (
       m == "jax" or m.startswith("jax.") or m == "nomad_tpu"
       or m.startswith("nomad_tpu."))]
assert not bad, bad
print("placed", len(placed), "lanes", gw.stats["lanes_sum"])
"""


def test_port_places_a_job_without_jax_or_nomad_tpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", PLACE_ONE_JOB], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "placed 10 lanes 2" in res.stdout


def _sources():
    # _build/ holds build outputs (gitignored), not package source
    files = sorted(f for f in (REPO / "nomad_tpu_torch").rglob("*.py")
                   if "_build" not in f.relative_to(REPO).parts)
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_nomad_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "nomad_tpu"), \
                f"{path}:{node.lineno} imports {name}"


# The one file of the port that reads the environment, and what it may
# read there: Nomad's documented user inputs of the command line (the ACL
# token, the target region and the jobspec's NOMAD_VAR_* variables).
ENV_INPUTS_FILE = "nomad_tpu_torch/cli/main.py"
ENV_INPUTS = ("NOMAD_TOKEN", "NOMAD_REGION")
ENV_VAR_PREFIX = "NOMAD_VAR_"


def _is_os_environ(node):
    return isinstance(node, ast.Attribute) and node.attr == "environ" \
        and isinstance(node.value, ast.Name) and node.value.id == "os"


def _is_prefix_filter(stmt, target):
    """`if <key>.startswith("NOMAD_VAR_"): ...`, <key> the loop's first
    name, with no else."""
    if not (isinstance(stmt, ast.If) and not stmt.orelse
            and isinstance(target, ast.Tuple) and target.elts
            and isinstance(target.elts[0], ast.Name)):
        return False
    t = stmt.test
    return isinstance(t, ast.Call) and isinstance(t.func, ast.Attribute) \
        and t.func.attr == "startswith" \
        and isinstance(t.func.value, ast.Name) \
        and t.func.value.id == target.elts[0].id \
        and len(t.args) == 1 and isinstance(t.args[0], ast.Constant) \
        and t.args[0].value == ENV_VAR_PREFIX


def environment_reads(source, rel):
    """The environment reads of a source file (its path `rel` from the
    repository's root) that the port may not make: every os.environ,
    os.getenv, os.putenv and os.environb, except, in ENV_INPUTS_FILE
    only, `os.environ.get(<one of ENV_INPUTS>, ...)` and a loop `for k,
    v in os.environ.items():` whose whole body is `if
    k.startswith("NOMAD_VAR_"): ...`."""
    tree = ast.parse(source)
    allowed = set()
    if rel == ENV_INPUTS_FILE:
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "get" and \
                    _is_os_environ(node.func.value) and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    node.args[0].value in ENV_INPUTS:
                allowed.add(id(node.func.value))
            if isinstance(node, ast.For) and not node.orelse and \
                    isinstance(node.iter, ast.Call) and \
                    not node.iter.args and \
                    isinstance(node.iter.func, ast.Attribute) and \
                    node.iter.func.attr == "items" and \
                    _is_os_environ(node.iter.func.value) and \
                    len(node.body) == 1 and \
                    _is_prefix_filter(node.body[0], node.target):
                allowed.add(id(node.iter.func.value))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and id(node) not in allowed \
                and node.attr in ("environ", "getenv", "putenv",
                                  "environb"):
            found.append(f"{rel}:{node.lineno} reads os.{node.attr}")
        if isinstance(node, ast.ImportFrom) and node.module == "os":
            names = {a.name for a in node.names}
            if names & {"environ", "getenv", "putenv", "environb"}:
                found.append(f"{rel}:{node.lineno} imports "
                             f"{sorted(names)} from os")
    return found


@pytest.mark.parametrize("path", _sources()[:-1],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_environment_read(path):
    """The port reads no environment variable: no os.environ, os.getenv
    or os.putenv anywhere in nomad_tpu_torch/, except the command line's
    documented user inputs in cli/main.py (environment_reads)."""
    found = environment_reads(path.read_text(),
                              str(path.relative_to(REPO)))
    assert not found, found


SERVE_JOBS = r"""
import sys
sys.modules["jax"] = None
sys.modules["nomad_tpu"] = None
import time
from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server, ServerConfig
s = Server(ServerConfig(num_schedulers=2, eval_batch_size=4), device="cpu")
s.start()
try:
    for i in range(8):
        s.register_node(mock.node())
    jobs = [mock.job() for _ in range(3)]
    for j in jobs:
        j.task_groups[0].count = 2
        s.register_job(j)
    deadline = time.time() + 60
    while time.time() < deadline and not all(
            len(s.store.allocs_by_job(j.namespace, j.id)) == 2
            for j in jobs):
        time.sleep(0.02)
    placed = sum(len(s.store.allocs_by_job(j.namespace, j.id))
                 for j in jobs)
finally:
    s.shutdown()
bad = [m for m, mod in sys.modules.items() if mod is not None and (
       m == "jax" or m.startswith("jax.") or m == "nomad_tpu"
       or m.startswith("nomad_tpu."))]
assert not bad, bad
print("served", placed)
"""


def test_port_server_runs_without_jax_or_nomad_tpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", SERVE_JOBS], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "served 6" in res.stdout


RESTART_JOBS = r"""
import sys
sys.modules["jax"] = None
sys.modules["nomad_tpu"] = None
import shutil
import tempfile
import time
from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server, ServerConfig
d = tempfile.mkdtemp()
cfg = dict(num_schedulers=1, heartbeat_ttl_s=3600.0, data_dir=d)
s = Server(ServerConfig(**cfg), device="cpu")
s.start()
try:
    for i in range(8):
        s.register_node(mock.node())
    job = mock.job()
    job.task_groups[0].count = 3
    s.register_job(job)
    deadline = time.time() + 60
    while time.time() < deadline and \
            len(s.store.allocs_by_job(job.namespace, job.id)) < 3:
        time.sleep(0.02)
finally:
    s.shutdown()
s = Server(ServerConfig(**cfg), device="cpu")
try:
    restored = len(s.store.allocs_by_job(job.namespace, job.id))
finally:
    s.shutdown()
    shutil.rmtree(d)
bad = [m for m, mod in sys.modules.items() if mod is not None and (
       m == "jax" or m.startswith("jax.") or m == "nomad_tpu"
       or m.startswith("nomad_tpu."))]
assert not bad, bad
print("restored", restored)
"""


def test_port_server_restarts_without_jax_or_nomad_tpu():
    """The durable server's WAL, snapshot codec and restore reach nothing
    of JAX or of the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", RESTART_JOBS], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "restored 3" in res.stdout


def test_select_kernel_without_device_needs_cuda():
    from nomad_tpu_torch.ops.select import SelectKernel
    if torch.cuda.is_available():
        assert SelectKernel().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            SelectKernel()
    assert SelectKernel("cpu").device.type == "cpu"


def test_harness_without_device_needs_cuda():
    from nomad_tpu_torch.scheduler.stack import PlacementEngine
    from nomad_tpu_torch.state import StateStore
    snap = StateStore().snapshot()
    if torch.cuda.is_available():
        assert PlacementEngine(snap).kernel.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            PlacementEngine(snap)


def test_chip_smoke_fails_without_a_card():
    """Where CUDA is absent the smoke script exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_build_covers_every_cuda_source():
    """The kernels' build compiles, and its key hashes, every CUDA source
    of the package, and its key hashes every header they include: a .cu
    file left out would never be built, a header left out would not
    rebuild the kernels when it changes."""
    from nomad_tpu_torch.ops import kernels
    csrc = REPO / "nomad_tpu_torch" / "ops" / "csrc"
    assert sorted(kernels.SOURCES) == sorted(csrc.glob("*.cu"))
    assert len(kernels.SOURCES) == 3
    assert sorted(kernels.HEADERS) == sorted(csrc.glob("*.cuh"))
