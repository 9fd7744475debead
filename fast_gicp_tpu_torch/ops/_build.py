"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` process (all started
together) for `sm_90a`, and the objects are linked into one shared library
with a plain C interface, loaded through `ctypes`.  The build runs at the
first kernel launch and is cached under `fast_gicp_tpu_torch/_build/` by a
hash of the sources and flags, so a fresh checkout builds once and later
processes load the cached library.  Precise `expf`/`sinf`/`cosf`/`sqrtf`
are required, so there is no `--use_fast_math`.  The linearize (GICP and
NDT), error, LM-trial and block-tridiagonal kernels are compiled without FMA contraction
(`-fmad=false`): they are bound by bytes and launches, not operations, and
so their per-element results round as the plain PyTorch versions do, which
keeps the Mahalanobis inverses of near-singular sums (aux) and the 6x6
solve within 1e-5 of them, and the trial step gives the same bits in every
kernel that runs it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", ARCH)
NO_FMA = ("block_tridiag.cu", "linearize.cu", "lm_trial.cu", "ndt_linearize.cu",
          "trial_error.cu")  # -fmad=false

_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built"
        )
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Path of the shared library for the current sources (built if absent)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + NO_FMA).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libfgt_kernels_{digest.hexdigest()[:16]}.so"
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(prefix="build_", dir=BUILD_DIR))
    try:
        units = sorted(CSRC.glob("*.cu"))
        objs = [work / f"{src.stem}.o" for src in units]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *(["-fmad=false"] if src.name in NO_FMA else []),
                 "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(units, objs)
        ]
        logs, failed = [], []
        for src, proc in zip(units, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_so = work / so.name
        link = subprocess.run(
            [nvcc, ARCH, "-shared", "-o", str(tmp_so), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (BUILD_DIR / f"{so.stem}.log").write_text(log)
        os.replace(tmp_so, so)  # atomic: a reader never sees a partial file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    with _lock:
        return ctypes.CDLL(str(library_path()))


def build_log() -> str:
    """The compiler output (ptxas register and shared-memory report) of the
    library's build."""
    return library_path().with_suffix(".log").read_text()


@functools.cache
def function(name: str, argtypes: tuple):
    """C entry `name` of the kernel library with its ctypes signature set;
    every entry returns a cudaError_t as int."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
