"""What the kernel profile scripts share: a copy of the kernels' sources
with `clock64()` probes inserted at exact-text anchors, and the kernels'
library built from a copy of the sources and made current.

Imported by scripts/profile_scan.py and scripts/profile_sharded_kway.py
(run from the repository's root as `python3 scripts/<name>.py`)."""

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
    getattr(kernels, "_SCAN_INFO", {}).clear()
    kernels.SOURCES = tuple(src / p.name for p in kernels.SOURCES)
    kernels.HEADERS = tuple(src / p.name for p in kernels.HEADERS)
    kernels.BUILD_DIR = build
    return kernels.load_library()


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
