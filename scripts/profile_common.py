"""What the kernel profile scripts share: a copy of the kernels' sources
with `clock64()` probes inserted at exact-text anchors, and the kernels'
library built from a copy of the sources and made current.

Imported by scripts/profile_scan.py and scripts/profile_sharded_kway.py
(run from the repository's root as `python3 scripts/<name>.py`)."""

import shutil
import subprocess
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
