"""Build the port's CUDA kernels from `csrc/` and load them.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface, loaded with `ctypes` (no PyTorch headers, so
a build takes seconds). Builds happen at first use, never at import,
into `paddle_tpu_torch/build/`, under a file name keyed on a hash of
the source and the flags: a changed source builds anew, an unchanged
one loads what is there. A failed build raises with nvcc's output.

`build_all()` starts one nvcc per source, all at once, and waits for
them — what a cold process (the chip smoke) calls first.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

# -Xptxas -v: registers, shared memory and spills per kernel, kept in
# the build log beside each library
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from "
            "paddle_tpu_torch/csrc at first use and need the CUDA "
            "toolkit"
        )
    return path


def sources() -> dict:
    """{kernel name: source path} for every `csrc/*.cu`."""
    return {
        os.path.splitext(os.path.basename(p))[0]: p
        for p in sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))
    }


def _target(name: str) -> str:
    h = hashlib.sha256()
    with open(sources()[name], "rb") as f:
        h.update(f.read())
    for hdr in sorted(glob.glob(os.path.join(SRC_DIR, "*.cuh"))):
        with open(hdr, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for `name` unless its library exists; returns
    (process, tmp path, target, log path) or None."""
    target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    log = os.path.splitext(target)[0] + ".log"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, sources()[name]]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target, log


def _finish(name: str, started) -> None:
    proc, tmp, target, log = started
    output, _ = proc.communicate()
    with open(log, "w") as f:
        f.write(output)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building {name} (exit {proc.returncode}):\n"
            f"{output}"
        )
    os.replace(tmp, target)   # atomic: a reader never sees half a file


def build_all() -> dict:
    """Build every kernel (one nvcc per source, in parallel) and load
    them. Returns {name: ctypes.CDLL}."""
    with _lock:
        started = {n: _start(n) for n in sources() if n not in _libs}
        try:
            for name, st in started.items():
                if st is not None:
                    _finish(name, st)
        finally:
            for st in started.values():
                if st is not None and st[0].poll() is None:
                    st[0].kill()
                    st[0].wait()
        for name in started:
            _libs[name] = ctypes.CDLL(_target(name))
        return dict(_libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            st = _start(name)
            if st is not None:
                _finish(name, st)
            lib = _libs[name] = ctypes.CDLL(_target(name))
        return lib


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) of the
    current build of `name`, or "" when it was built elsewhere."""
    log = os.path.splitext(_target(name))[0] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()
