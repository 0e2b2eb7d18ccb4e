"""Build the CUDA kernels of csrc/ with nvcc and load them with ctypes.

The sources (`csrc/*.cu`, `csrc/*.cuh`) compile into one shared library
with a plain C interface.  Each `.cu` compiles on its own, all at once
(one nvcc process each), then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xcompiler -fPIC -Xptxas -v -c -o <src>.o csrc/<src>.cu
    nvcc -shared -o <lib> <src>.o ...

`--fmad=false` keeps nvcc from contracting the delay estimator's float32
`a*b + c` into FMAs, so the kernel rounds like the plain PyTorch version.
The library goes to build/torch_kernels/ under the repository root, named
by a hash of the sources and flags, and is built at first use (a second
call finds it).  The ptxas report (registers, spills) is kept beside it.
Nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_info = {}      # filled by load_library: path, seconds, ptxas report


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "/usr/local/cuda") + "/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA toolkit needed to build "
                       "the kernels)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libaecm_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not there; returns its path."""
    so = library_path()
    if so.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("cached", True)
        build_info["path"] = str(so)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc] + NVCC_FLAGS + ["-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    reports = [proc.communicate()[1] for _, proc in jobs]  # wait for all
    for (_, proc), err in zip(jobs, reports):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{err}")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp)]
                         + [str(obj) for obj, _ in jobs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    for obj, _ in jobs:
        obj.unlink()
    seconds = time.perf_counter() - t0
    report = "".join(reports)
    so.with_suffix(".ptxas.txt").write_text(report)
    os.replace(tmp, so)
    build_info.update(path=str(so), seconds=seconds, cached=False,
                      ptxas=report)
    return so


def load_library():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.aecm_ring_multi_pass.argtypes = [vp] * 6 + [ci] * 4 + [vp]
    lib.aecm_ring_multi_pass.restype = ci
    lib.aecm_ring_gather.argtypes = [vp] * 3 + [ci] * 3 + [vp]
    lib.aecm_ring_gather.restype = ci
    lib.aecm_ring_write.argtypes = [vp] * 4 + [ci] * 3 + [vp]
    lib.aecm_ring_write.restype = ci
    lib.aecm_frames_step.argtypes = ([ctypes.POINTER(vp), ci] + [vp] * 10
                                     + [ci] * 4 + [vp])
    lib.aecm_frames_step.restype = ci
    lib.aecm_error_string.argtypes = [ci]
    lib.aecm_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, name: str):
    """Raise if a C entry point returned a CUDA error (or a negative
    argument error)."""
    if err == 0:
        return
    if err < 0:
        raise ValueError(f"{name}: bad arguments (code {err})")
    text = _lib.aecm_error_string(err).decode() if _lib else ""
    raise RuntimeError(f"{name}: CUDA error {err} {text}")
