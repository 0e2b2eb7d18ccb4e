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

Every kernel wrapper goes through one launch path: `require` checks each
tensor argument by attribute reads and raises on what the kernel does not
take (nothing is converted), and `launch` calls the C entry point on the
current stream of the tensors' card, with that card made the current CUDA
device for the call, and raises on its return code.  Neither synchronises
nor reads a tensor's value on the host.
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


_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
# C entry point -> argument types; each also takes the stream, last
_SIGNATURES = {
    "aecm_noop": [],
    "aecm_ring_multi_pass": [_VP] * 6 + [_CI] * 4,
    "aecm_ring_write": [_VP] * 5 + [_CL] + [_VP] * 2 + [_CI] * 3,
    "aecm_ring_read": [_VP] * 9 + [_CI] * 5,
    "aecm_frames_step": [_VP, _CI] + [_VP] * 11 + [_CI] * 9,
}
_entry = {}          # C entry point -> its ctypes function, set at first use
_raw_stream = None   # device index -> the current stream's handle (an int)
_current_device = None   # () -> the current CUDA device's index


def load_library():
    """The loaded kernel library (built at first use), with every entry
    point's argument types bound, so that plain ints pass as pointers."""
    global _lib, _raw_stream, _current_device
    if _lib is not None:
        return _lib
    import torch
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes + [_VP]
        fn.restype = _CI
        _entry[name] = fn
    lib.aecm_frames_layout.argtypes = [_CI] * 5 + [ctypes.POINTER(_CI)] * 3
    lib.aecm_frames_layout.restype = _CI
    lib.aecm_error_string.argtypes = [_CI]
    lib.aecm_error_string.restype = ctypes.c_char_p
    # CUDA builds of PyTorch give the raw handle without a Stream object
    _raw_stream = getattr(
        torch._C, "_cuda_getCurrentRawStream",
        lambda index: torch.cuda.current_stream(index).cuda_stream)
    _current_device = getattr(torch._C, "_cuda_getDevice",
                              torch.cuda.current_device)
    _lib = lib
    return lib


def require(x, what: str, dtype, shape, device):
    """Raise unless tensor x is what a kernel takes as it stands: of
    `dtype` and `shape`, contiguous, on `device`."""
    if (x.dtype != dtype or x.shape != shape or x.device != device
            or not x.is_contiguous()):
        raise ValueError(
            f"{what} must be a contiguous {tuple(shape)} {dtype} tensor on "
            f"{device}; got {tuple(x.shape)} {x.dtype} on {x.device}"
            + ("" if x.is_contiguous() else ", not contiguous"))


def launch(name: str, device_index: int, *args):
    """Call C entry point `name` with `args` and the current stream of CUDA
    device `device_index`, with that device current (the C side sets
    per-card kernel attributes on the current device, and a launch goes to
    the current device's context); raise on a non-zero return code.  The
    switch is skipped when the device is current already.  The library is
    built and its functions resolved at the first launch."""
    fn = _entry.get(name)
    if fn is None:
        load_library()
        fn = _entry[name]
    if _current_device() == device_index:
        err = fn(*args, _raw_stream(device_index))
    else:
        import torch
        with torch.cuda.device(device_index):
            err = fn(*args, _raw_stream(device_index))
    if err:
        check(err, name)


def check(err: int, name: str):
    """Raise if a C entry point returned a CUDA error (or a negative
    argument error)."""
    if err == 0:
        return
    if err < 0:
        raise ValueError(f"{name}: bad arguments (code {err})")
    text = _lib.aecm_error_string(err).decode() if _lib else ""
    raise RuntimeError(f"{name}: CUDA error {err} {text}")
