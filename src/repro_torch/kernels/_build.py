"""Build every CUDA source of the port into one shared library; load it.

Each ``.cu`` under ``src/repro_torch/kernels/**/csrc/`` is compiled by its
own ``nvcc`` (all started together) for ``sm_90a`` into an object file;
the objects are linked into one ``.so`` with a plain C interface, which is
loaded with :mod:`ctypes`.  The library goes to ``build/repro_torch/`` at
the repository root and is named by a hash of the sources and flags, so it
is built at first use and rebuilt when a source changes.  A failed build
raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list[Path]:
    """The CUDA sources of every kernel, in a fixed order."""
    return sorted(KERNELS_DIR.glob("**/csrc/*.cu"))


def _tag() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in sorted(KERNELS_DIR.glob("**/csrc/*.cu*")):
        h.update(p.relative_to(KERNELS_DIR).as_posix().encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_kernels-{_tag()}.so"


def log_path() -> Path:
    """nvcc's output of the last build of this library (``-Xptxas -v``)."""
    return library_path().with_suffix(".log")


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the port's CUDA kernels are built from source at first use")


def build() -> Path:
    """Compile and link the kernels unless this exact library exists."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {KERNELS_DIR}")
    tmp = BUILD_DIR / f"tmp-{lib.stem}-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        objs = [tmp / f"{i}_{s.stem}.o" for i, s in enumerate(srcs)]
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s, log) for s, p, log in zip(srcs, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {s.relative_to(KERNELS_DIR)} ---\n{log}" for s, log in failed))
        out = tmp / lib.name
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(out), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "build.log").write_text("".join(
            f"--- {s.relative_to(KERNELS_DIR)} ---\n{log}" for s, log in zip(srcs, logs)))
        os.replace(tmp / "build.log", log_path())
        os.replace(out, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernels' shared library (built first if needed), loaded once."""
    return ctypes.CDLL(str(build()))
