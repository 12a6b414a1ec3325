"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/horovod_tpu_torch/lib<name>-<hash>.so <name>.cu

at first use, from the sources in the checkout.  The file name carries a
hash of the source and of the shared headers (``csrc/*.cuh``), so an edited
kernel is rebuilt and a built one is reused.  :func:`build_all` starts one
``nvcc`` per source, all at once.
Nothing here runs at import time: the CPU tests import every module and
this machine may have no ``nvcc``.

The native coordination engine (the repo's top-level ``native/src/``:
``controller.cc transport.cc c_api.cc``, plain C++ with a C interface) is
built the same way with ``g++`` and the flags of ``native/Makefile``, into
``build/horovod_tpu_torch/libhvdtpu-<hash>.so`` (:func:`load_controller`).
Every build writes a temporary file and renames it into place, behind a
lock file in the build directory, so that processes building at once (the
tests run in several) never load a half-written library.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "horovod_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

NATIVE_SRC = Path(__file__).resolve().parent.parent / "native" / "src"
NATIVE_SOURCES = ("controller.cc", "transport.cc", "c_api.cc")
# native/Makefile's CXXFLAGS, and -shared.
NATIVE_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
                "-shared"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}      # name -> nvcc's -Xptxas -v report


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


@contextlib.contextmanager
def _file_lock():
    """Hold ``build/horovod_tpu_torch/.lock`` (``flock``: released when its
    holder exits, so a killed build leaves no stale lock)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _target(name)
    if out.exists():
        return None
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every kernel source that is not built yet, one ``nvcc``
    process per source, all started together."""
    with _lock, _file_lock():
        names = sources()
        started = [(n, _start(n)) for n in names]
        errors = []
        for name, s in started:
            try:
                _finish(name, s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The ``ctypes`` handle of kernel library ``name``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            with _file_lock():
                _finish(name, _start(name))
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def controller_target() -> Path:
    h = hashlib.sha256(" ".join(NATIVE_FLAGS).encode())
    for p in sorted(NATIVE_SRC.glob("*.h")) + [NATIVE_SRC / s
                                               for s in NATIVE_SOURCES]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"libhvdtpu-{h.hexdigest()[:16]}.so"


def start_controller_build() -> tuple[subprocess.Popen, Path, Path] | None:
    """Start ``g++`` on the controller's sources (None if built): lets a
    caller overlap it with the kernels' ``nvcc`` (:func:`build_controller`
    waits for it)."""
    out = controller_target()
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native controller is built "
                           "from native/src with a C++17 compiler")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *NATIVE_FLAGS, "-o", str(tmp),
           *(str(NATIVE_SRC / s) for s in NATIVE_SOURCES)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_controller(started=None) -> Path:
    """Build (or finish building) the controller library; its path."""
    with _lock, _file_lock():
        if started is None:
            started = start_controller_build()
        if started is not None:
            proc, tmp, out = started
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed to build native/src:\n{log}")
            os.replace(tmp, out)
    return controller_target()
