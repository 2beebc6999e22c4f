"""What the kernel profile scripts share: a copy of the kernels' sources
with `clock64()` probes inserted at exact-text anchors, the kernels'
library built from a copy of the sources and made current, one
instrumented call's probe sums, and the A/B of builds of several copies
of the sources.

Imported by scripts/profile_scan.py, scripts/profile_chunked.py and
scripts/profile_sharded_kway.py (run from the repository's root as
`python3 scripts/<name>.py`)."""

import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

# read and reset the probes' sums (g_prof, `slots` 64-bit words) from the
# host; appended to a source that defines g_prof
PROBE_ACCESS = """
extern "C" int nomad_prof_read(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
extern "C" int nomad_prof_reset() {
    unsigned long long z[%d] = {0};
    return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
"""


def copy_sources(src: Path, dst: Path) -> None:
    """The files of the sources' directory `src` copied into `dst`."""
    dst.mkdir(parents=True, exist_ok=True)
    for f in src.iterdir():
        if f.is_file():
            shutil.copy(f, dst / f.name)


def insert(text: str, anchor: str, probe: str, where: str,
           before: bool = False) -> str:
    """`probe` inserted after (or before) `anchor`, which must occur in
    `text` exactly once; `where` names the place in the error raised
    otherwise, so that an edit of the kernel that moves an anchor stops
    the profile instead of probing the wrong place."""
    if text.count(anchor) != 1:
        raise SystemExit(f"profile: the anchor of {where} is not in the "
                         f"source exactly once:\n{anchor}")
    return text.replace(anchor, probe + anchor if before else anchor + probe,
                        1)


def load(kernels, src: Path, build: Path):
    """The kernels' library built from the sources in `src` into `build`,
    made current for the wrappers of `kernels`."""
    kernels._LIB = None
    kernels._MAX_SHARDS.clear()
    for cache in ("_SCAN_INFO", "_CHUNK_INFO", "_CHUNK_PLAN"):
        getattr(kernels, cache, {}).clear()
    kernels.SOURCES = tuple(src / p.name for p in kernels.SOURCES)
    kernels.HEADERS = tuple(src / p.name for p in kernels.HEADERS)
    kernels.BUILD_DIR = build
    return kernels.load_library()


def flat(got) -> list:
    """A wrapper's result, (carry, outputs), as one list of tensors."""
    return list(got[0]) + list(got[1])


def same(want, got) -> bool:
    """Two lists of tensors equal bit for bit."""
    import torch
    return all(torch.equal(a, b) for a, b in zip(want, got))


def probe_sums(kernels, lib, run, want, slots: int, label: str,
               name: str = "prof"):
    """The probes' sums (`slots` words, read by nomad_<name>_read) of one
    call of `run` with the instrumented library `lib` made current, after
    a first call whose outputs must equal `want` (the plain build's, flat)
    bit for bit."""
    import torch
    kernels._LIB = lib
    got = flat(run())
    torch.cuda.synchronize()
    if not same(want, got):
        raise SystemExit(f"profile: {label}: the instrumented kernel's "
                         f"outputs differ")
    getattr(lib, f"nomad_{name}_reset")()
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * slots)()
    getattr(lib, f"nomad_{name}_read")(buf)
    return buf


def compare_builds(cs, kernels, srcs, build: Path, todo, rounds: int,
                   info, graph: bool = False) -> None:
    """The A/B of the kernels built from each directory of sources in
    `srcs` (into `build`/i): at each case (label, wrapper, arguments,
    keyword arguments) of `todo`, every build's outputs held bit for bit
    against the first's, then the builds timed `rounds` rounds in turn,
    in reverse order every other round. One line `COMPARE {json}` a case:
    `info(first build's flat outputs, keyword arguments)` (the steps it
    ran), and each build's median, least and most time, by CUDA events
    around a call (`ms`, each a median of 7) and, with `graph`, as device
    time from calls replayed from a CUDA graph (`graph_ms`)."""
    import statistics
    import torch
    names = [s.name for s in srcs]
    libs = [load(kernels, s, build / str(i)) for i, s in enumerate(srcs)]
    clocks = dict(ms=cs.cuda_ms)
    if graph:
        clocks["graph_ms"] = lambda fn: cs.graph_ms(fn, launches=10)
    for label, run, targs, kw in todo:
        call = lambda: run(**targs, **kw)   # noqa: E731
        outs = []
        for lib in libs:
            kernels._LIB = lib
            outs.append(flat(call()))
            torch.cuda.synchronize()
        for name, got in zip(names[1:], outs[1:]):
            if not same(outs[0], got):
                raise SystemExit(f"compare: {label}: {name}'s outputs "
                                 f"differ from {names[0]}'s")
        spent = {c: [[] for _ in libs] for c in clocks}
        for r in range(rounds):
            order = list(range(len(libs)))
            for i in order if r % 2 == 0 else order[::-1]:
                kernels._LIB = libs[i]
                for c, clock in clocks.items():
                    spent[c][i].append(clock(call))
        row = dict(case=label, **info(outs[0], kw), rounds=rounds)
        for c in clocks:
            row[c] = {n: dict(median=statistics.median(t), least=min(t),
                              most=max(t))
                      for n, t in zip(names, spent[c])}
        print("COMPARE " + json.dumps(row), flush=True)


def ptxas_report(kernels, source: str, kernel: str) -> str:
    """`ptxas -v`'s registers, spills and shared memory of the entry
    function `kernel` of `source` (matched by its mangled name's prefix,
    so that scan_kernel is not scan_batched_kernel)."""
    out = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         "/dev/null", str(kernels._CSRC / source)],
        capture_output=True, text=True).stderr.splitlines()
    mangled = f"'_Z{len(kernel)}{kernel}"
    at = next(i for i, ln in enumerate(out)
              if "Compiling entry function" in ln and mangled in ln)
    return " ".join(ln.split(":", 1)[-1].strip() for ln in out[at + 2:at + 4])


def local_memory(kernels, source: str, kernel: str) -> dict:
    """The local-memory loads and stores (LDL, STL) in the SASS of the
    entry function `kernel` of `source` (a cubin built with the kernels'
    flags and -lineinfo, read by nvdisasm), and the loads counted by the
    source line they were compiled from ("file:line", the innermost
    line)."""
    cuda = Path(kernels._nvcc()).parent
    with tempfile.TemporaryDirectory() as d:
        cubin = Path(d) / "k.cubin"
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-lineinfo",
                        "-cubin", "-o", str(cubin),
                        str(kernels._CSRC / source)], check=True)
        sass = subprocess.run([str(cuda / "nvdisasm"), "--print-line-info",
                               str(cubin)], capture_output=True, text=True,
                              check=True).stdout.splitlines()
    mangled = f"_Z{len(kernel)}{kernel}"
    ours, where = False, ""
    out = dict(kernel=kernel, instructions=0, ldl=0, stl=0, loads={})
    for ln in sass:
        if ".text." in ln and ln.lstrip().startswith(".section"):
            ours = f".text.{mangled}" in ln
            continue
        if not ours:
            continue
        if "//## File" in ln:
            at = re.search(r'"([^"]+)", line (\d+)', ln)
            where = f"{Path(at[1]).name}:{at[2]}" if at else ""
            continue
        code = ln.split("*/", 1)[-1].strip() if "/*" in ln else ""
        if not code or not code.endswith(";"):
            continue
        out["instructions"] += 1
        if re.search(r"\bSTL\b|\bSTL\.", code):
            out["stl"] += 1
        if re.search(r"\bLDL\b|\bLDL\.", code):
            out["ldl"] += 1
            out["loads"][where] = out["loads"].get(where, 0) + 1
    return out
