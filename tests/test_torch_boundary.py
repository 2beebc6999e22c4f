"""The port's boundary: nomad_tpu_torch and chip_smoke.py import neither JAX
nor anything of nomad_tpu, and the port never runs on the CPU unless it
is asked to."""

import ast
import os
import re
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


# The environment a spawned process is handed, and the two secrets a
# child entry point reads from the environment its parent built, by file:
# (the function that holds the read, the read). A read is `get:<key>`,
# os.environ.get(<key>, ...) with <key> a string or a name, or `copy`,
# dict(os.environ).
CHILD_ENV_READS = {
    # the PATH a spawned executor, log collector or plugin runs with
    "nomad_tpu_torch/client/drivers.py": {
        ("child_process_env", 'get:"PATH"')},
    # the executor's handshake cookie and auth token, read in the child
    "nomad_tpu_torch/client/executor_server.py": {
        ("main", "get:HANDSHAKE_COOKIE_KEY"),
        ("main", 'get:"NOMAD_TPU_TORCH_EXECUTOR_TOKEN"')},
    # a plugin's handshake cookie, read in the child
    "nomad_tpu_torch/plugins/base.py": {
        ("serve_plugin", "get:HANDSHAKE_COOKIE_KEY")},
    # the environment a plugin process is launched with
    "nomad_tpu_torch/plugins/device_client.py": {
        ("_ensure_running", "copy")},
    "nomad_tpu_torch/plugins/driver_client.py": {
        ("_ensure_running", "copy")},
}


def _is_os_environ(node):
    return isinstance(node, ast.Attribute) and node.attr == "environ" \
        and isinstance(node.value, ast.Name) \
        and node.value.id in ("os", "_os")


def _child_env_reads(tree):
    """{(function, read): the os.environ node} of a module's reads of
    the CHILD_ENV_READS forms."""
    out = {}
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "get" and \
                    _is_os_environ(f.value) and node.args:
                key = node.args[0]
                if isinstance(key, ast.Constant):
                    out[(fn.name, f'get:"{key.value}"')] = f.value
                elif isinstance(key, ast.Name):
                    out[(fn.name, f"get:{key.id}")] = f.value
            if isinstance(f, ast.Name) and f.id == "dict" and \
                    len(node.args) == 1 and not node.keywords and \
                    _is_os_environ(node.args[0]):
                out[(fn.name, "copy")] = node.args[0]
    return out


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
    k.startswith("NOMAD_VAR_"): ...`, and the reads CHILD_ENV_READS
    names for the file."""
    tree = ast.parse(source)
    allowed = set()
    names = CHILD_ENV_READS.get(rel, set())
    for key, node in _child_env_reads(tree).items():
        if key in names:
            allowed.add(id(node))
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
    documented user inputs in cli/main.py and the child-process reads
    of CHILD_ENV_READS (environment_reads)."""
    found = environment_reads(path.read_text(),
                              str(path.relative_to(REPO)))
    assert not found, found


@pytest.mark.parametrize("rel", sorted(CHILD_ENV_READS))
def test_child_env_reads_name_real_reads(rel):
    """Every read the allowlist names is in its file, in its function."""
    reads = _child_env_reads(ast.parse((REPO / rel).read_text()))
    assert CHILD_ENV_READS[rel] <= set(reads), (rel, sorted(reads))


@pytest.mark.parametrize("code,where", [
    # a child-process read in another function of its file
    ("import os\ndef f():\n    return dict(os.environ)\n",
     "nomad_tpu_torch/plugins/device_client.py"),
    # another key in the function that may read one
    ("import os\ndef main():\n    return os.environ.get('HOME')\n",
     "nomad_tpu_torch/client/executor_server.py"),
    # an allowed read in a file the allowlist does not name
    ("import os\ndef _ensure_running():\n    return dict(os.environ)\n",
     "nomad_tpu_torch/client/agent.py"),
])
def test_env_rule_refuses_child_reads_out_of_place(code, where):
    assert environment_reads(code, where)


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


RUN_A_CLIENT = r"""
import sys
sys.modules["jax"] = None
sys.modules["nomad_tpu"] = None
import time
from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.server import Server, ServerConfig
s = Server(ServerConfig(num_schedulers=1), device="cpu")
s.start()
c = Client(s, ClientConfig(node_name="boundary-client"))
c.start()
try:
    job = mock.batch_job()
    job.task_groups[0].count = 2
    job.task_groups[0].tasks[0].config = {"run_for": "50ms"}
    s.register_job(job)
    deadline = time.time() + 60
    def done():
        allocs = s.store.allocs_by_job(job.namespace, job.id)
        return len(allocs) == 2 and all(
            a.client_status == "complete" for a in allocs)
    while time.time() < deadline and not done():
        time.sleep(0.02)
    status = sorted(a.client_status
                    for a in s.store.allocs_by_job(job.namespace, job.id))
finally:
    c.shutdown()
    s.shutdown()
bad = [m for m, mod in sys.modules.items() if mod is not None and (
       m == "jax" or m.startswith("jax.") or m == "nomad_tpu"
       or m.startswith("nomad_tpu."))]
assert not bad, bad
print("ran", status)
"""


def test_port_client_runs_a_job_without_jax_or_nomad_tpu():
    """A Server and a Client of the port run a mock_driver batch job to
    complete with JAX and the JAX package blocked."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", RUN_A_CLIENT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ran ['complete', 'complete']" in res.stdout


def _verbatim_copies():
    """The files nomad_tpu_torch/__init__.py lists as copies identical in
    code to the JAX package's file of the same path."""
    text = (REPO / "nomad_tpu_torch" / "__init__.py").read_text()
    start = text.index("identical in code")
    block = text[text.index(":", start) + 1:
                 text.index("Copies changed only")]
    block = re.sub(r"\([^)]*\)", "", block, flags=re.S)
    names = [n.strip().rstrip(".").strip()
             for n in block.replace("\n", " ").split(",")]
    files = []
    for name in filter(None, names):
        hits = sorted((REPO / "nomad_tpu_torch").glob(name))
        assert hits, name
        files += [str(h.relative_to(REPO / "nomad_tpu_torch"))
                  for h in hits]
    return files


def _code(path):
    """A module's syntax tree without its docstrings (comments are not
    in the tree)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body and \
                isinstance(node.body[0], ast.Expr) and \
                isinstance(node.body[0].value, ast.Constant) and \
                isinstance(node.body[0].value.value, str):
            node.body = node.body[1:] or [ast.Pass()]
    return ast.dump(tree, include_attributes=False)


@pytest.mark.parametrize("rel", _verbatim_copies())
def test_verbatim_copies_are_identical_in_code(rel):
    assert _code(REPO / "nomad_tpu_torch" / rel) == \
        _code(REPO / "nomad_tpu" / rel), rel


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
