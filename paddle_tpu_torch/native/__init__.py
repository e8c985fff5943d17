"""Native runtime loader: builds (if needed) and binds the C++ shared
libraries via ctypes — `paddle_tpu/native/__init__.py` for the port.

The port keeps its own copy of the runtime's sources (`src/`,
`include/pt_capi.h`, the `Makefile` and `examples/model_inference/`)
and builds only those, with g++, into `paddle_tpu_torch/build/native/`
at first use:

- `libpaddle_tpu_torch_native.so` (`load`): the reference's native
  runtime pieces — paddle/optimizer/ (the standalone C-ABI optimizer
  library), RecordIO chunk IO + DoubleBuffer async prefetch
  (go/master/service.go:280, gserver/dataproviders/DataProvider.h:249)
  and the elastic master task queue with its TCP server
  (go/master/service.go);
- `libpaddle_tpu_torch_capi.so` (`build_capi`): the C inference ABI
  (`src/capi.cc`, which embeds CPython and calls
  `paddle_tpu_torch.capi_bridge`), linked as `python3-config
  --includes` and `--ldflags --embed` give it for the running Python.

A file lock serialises concurrent builds across processes (test
workers, trainers on a fresh checkout) and the Makefile renames each
library into place atomically. No pybind11: plain ctypes over an
`extern "C"` ABI. Nothing here touches a card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import sysconfig
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build", "native")
LIB_PATH = os.path.join(BUILD_DIR, "libpaddle_tpu_torch_native.so")
CAPI_PATH = os.path.join(BUILD_DIR, "libpaddle_tpu_torch_capi.so")
INCLUDE_DIR = os.path.join(_DIR, "include")
EXAMPLES_DIR = os.path.join(_DIR, "examples", "model_inference")
_lock = threading.Lock()
_lib = None

# each library's sources: a library older than any of them is rebuilt
_SOURCES = {
    LIB_PATH: ["src/optimizer.cc", "src/recordio.cc", "src/master.cc",
               "src/master_server.cc", "src/common.h", "Makefile"],
    CAPI_PATH: ["src/capi.cc", "include/pt_capi.h", "Makefile"],
}


def _needs_build(out: str) -> bool:
    if not os.path.exists(out):
        return True
    mtime = os.path.getmtime(out)
    return any(os.path.getmtime(os.path.join(_DIR, f)) > mtime
               for f in _SOURCES[out])


def _python_embed_flags() -> tuple:
    """(includes, link flags) to embed the running Python: its own
    `pythonX.Y-config` (beside the interpreter or on PATH), else
    `python3-config`, else the same flags from `sysconfig`."""
    ver = f"{sys.version_info.major}.{sys.version_info.minor}"
    for name in (os.path.join(os.path.dirname(sys.executable),
                              f"python{ver}-config"),
                 f"python{ver}-config", "python3-config"):
        exe = shutil.which(name)
        if exe is None:
            continue
        inc = subprocess.run([exe, "--includes"], capture_output=True,
                             text=True)
        ld = subprocess.run([exe, "--ldflags", "--embed"],
                            capture_output=True, text=True)
        if inc.returncode == 0 and ld.returncode == 0 and \
                f"python{ver}" in inc.stdout:
            return inc.stdout.strip(), ld.stdout.strip()
    cv = sysconfig.get_config_var
    inc = f"-I{sysconfig.get_path('include')} " \
          f"-I{sysconfig.get_path('platinclude')}"
    ld = f"-L{cv('LIBDIR')} -lpython{cv('LDVERSION')} " \
         f"{cv('LIBS') or ''} {cv('SYSLIBS') or ''}"
    return inc, ld.strip()


def _make(out: str, target=()) -> str:
    """Build `out` with make under the build lock (idempotent,
    mtime-cached); a failed build raises with the compiler's output."""
    if _needs_build(out):
        import fcntl

        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if _needs_build(out):  # re-check under the lock
                    cmd = ["make", "-s", "-C", _DIR, *target]
                    if out == CAPI_PATH:
                        inc, ld = _python_embed_flags()
                        cmd += [f"PY_INC={inc}", f"PY_LD={ld}"]
                    r = subprocess.run(cmd, capture_output=True, text=True)
                    if r.returncode != 0:
                        raise RuntimeError(
                            f"building {os.path.basename(out)} failed:\n"
                            f"{r.stdout}{r.stderr}")
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def build() -> str:
    """Compile the runtime library; returns its path."""
    return _make(LIB_PATH)


def build_capi() -> str:
    """Compile the C inference ABI library; returns its path."""
    return _make(CAPI_PATH, ("capi",))


def load() -> ctypes.CDLL:
    """Build if stale and dlopen; memoized."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())

        c = ctypes
        i64, f64, i32 = c.c_int64, c.c_double, c.c_int
        p = c.c_void_p
        cp = c.c_char_p

        # optimizer
        lib.pt_optimizer_create.restype = p
        lib.pt_optimizer_create.argtypes = [
            cp, i64, f64, f64, f64, f64, f64, f64, f64, cp, f64, f64,
        ]
        lib.pt_optimizer_destroy.argtypes = [p]
        lib.pt_optimizer_update.argtypes = [
            p, c.POINTER(c.c_float), c.POINTER(c.c_float), i64, i64,
        ]
        lib.pt_optimizer_state_size.restype = i64
        lib.pt_optimizer_state_size.argtypes = [p]
        lib.pt_optimizer_get_state.restype = i64
        lib.pt_optimizer_get_state.argtypes = [p, cp, i64]
        lib.pt_optimizer_set_state.restype = i32
        lib.pt_optimizer_set_state.argtypes = [p, cp, i64]

        # recordio
        lib.pt_recordio_writer_open.restype = p
        lib.pt_recordio_writer_open.argtypes = [cp, i64]
        lib.pt_recordio_write.restype = i32
        lib.pt_recordio_write.argtypes = [p, cp, i64]
        lib.pt_recordio_writer_close.restype = i32
        lib.pt_recordio_writer_close.argtypes = [p]
        lib.pt_recordio_reader_open.restype = p
        lib.pt_recordio_reader_open.argtypes = [
            c.POINTER(cp), i32, i32, i32, i32,
        ]
        lib.pt_recordio_next.restype = i64
        lib.pt_recordio_next.argtypes = [p, c.c_char_p, i64]
        lib.pt_recordio_peek_len.restype = i64
        lib.pt_recordio_peek_len.argtypes = [p]
        lib.pt_recordio_error.restype = cp
        lib.pt_recordio_error.argtypes = [p]
        lib.pt_recordio_reader_close.argtypes = [p]
        lib.pt_recordio_count_chunks.restype = i64
        lib.pt_recordio_count_chunks.argtypes = [cp]

        # master
        lib.pt_master_create.restype = p
        lib.pt_master_create.argtypes = [f64, i32]
        lib.pt_master_destroy.argtypes = [p]
        lib.pt_master_add_task.restype = i64
        lib.pt_master_add_task.argtypes = [p, cp, i64]
        lib.pt_master_get_task.restype = i64
        lib.pt_master_get_task.argtypes = [p, c.c_char_p, i64, c.POINTER(i64)]
        lib.pt_master_task_done.restype = i32
        lib.pt_master_task_done.argtypes = [p, i64]
        lib.pt_master_task_failed.restype = i32
        lib.pt_master_task_failed.argtypes = [p, i64]
        lib.pt_master_pass_finished.restype = i32
        lib.pt_master_pass_finished.argtypes = [p]
        lib.pt_master_start_pass.restype = i64
        lib.pt_master_start_pass.argtypes = [p]
        lib.pt_master_count.restype = i64
        lib.pt_master_count.argtypes = [p, i32]
        lib.pt_master_set_lease.argtypes = [p, f64]
        lib.pt_master_snapshot.restype = i32
        lib.pt_master_snapshot.argtypes = [p, cp]
        lib.pt_master_restore.restype = p
        lib.pt_master_restore.argtypes = [cp]
        lib.pt_master_request_save.restype = i32
        lib.pt_master_request_save.argtypes = [p, cp, f64]

        # master server (networked elastic master)
        lib.pt_master_server_start.restype = p
        lib.pt_master_server_start.argtypes = [p, i32, cp, f64]
        lib.pt_master_server_port.restype = i32
        lib.pt_master_server_port.argtypes = [p]
        lib.pt_master_server_stopped.restype = i32
        lib.pt_master_server_stopped.argtypes = [p]
        lib.pt_master_server_stop.argtypes = [p]

        _lib = lib
        return _lib
