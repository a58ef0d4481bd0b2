"""Builds the native sources in ``otgan_tpu_torch/csrc/`` into ctypes libraries.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so`` with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``.
The hash covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header builds anew
and an unchanged one loads from the build directory. All missing libraries
are compiled at once, one ``nvcc`` process per source started together.
A missing ``nvcc`` or a failed build raises; nothing degrades to another
path. Nothing is built at import: the first caller of :func:`load` builds.

The host library, ``csrc/otgan_host.cpp`` (the batch assembler), is built
by :func:`build_host` with ``g++ -O3 -march=native -shared -fPIC -std=c++17
-pthread`` into ``_build/libotgan_host-<hash>.so``; its hash also covers
the host's CPU, so code built for one CPU is never loaded on another host
that shares the directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

HOST_SRC = os.path.join(CSRC_DIR, "otgan_host.cpp")
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels of otgan_tpu_torch cannot be built"
    )


def sources() -> Dict[str, str]:
    """``{name: path}`` of every ``.cu`` file in ``csrc/``."""
    return {
        f[:-3]: os.path.join(CSRC_DIR, f)
        for f in sorted(os.listdir(CSRC_DIR))
        if f.endswith(".cu")
    }


def _headers() -> list:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cuh"))


def _lib_path(name: str, src: str) -> str:
    h = hashlib.sha256()
    for path in [src, *_headers()]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.
    Returns ``{name: library path}``; raises on the first failed build."""
    targets = {n: (s, _lib_path(n, s)) for n, s in sources().items()}
    todo = {n: t for n, t in targets.items() if not os.path.exists(t[1])}
    if todo:
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name, (src, out) in todo.items():
            tmp = f"{out}.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True,
                ),
                tmp,
                out,
            )
        errors = []
        for name, (proc, tmp, out) in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{name}: nvcc exited {proc.returncode}\n{err}")
                continue
            os.replace(tmp, out)  # atomic: no process sees half a library
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return {n: t[1] for n, t in targets.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            if name not in paths:
                raise KeyError(f"no CUDA source csrc/{name}.cu")
            _libs[name] = ctypes.CDLL(paths[name])
        return _libs[name]


def _cpu_identity() -> bytes:
    """What ``-march=native`` compiles for: the machine, and the first CPU's
    model and feature flags from ``/proc/cpuinfo`` where there is one."""
    ident = [platform.machine(), platform.processor()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's block
                if line.split(":")[0].strip() in ("vendor_id", "model name", "flags",
                                                  "Features", "CPU part"):
                    ident.append(line.strip())
    except OSError:
        pass
    return "\n".join(ident).encode()


def host_lib_path() -> str:
    """``_build/libotgan_host-<hash>.so``: the hash covers the source, the
    flags and the host's CPU."""
    h = hashlib.sha256()
    with open(HOST_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(HOST_FLAGS).encode())
    h.update(_cpu_identity())
    return os.path.join(BUILD_DIR, f"libotgan_host-{h.hexdigest()[:16]}.so")


def build_host(force: bool = False) -> str:
    """Compile the host library with ``g++`` unless it exists (``force``:
    anew, into a fresh file renamed over the old one, so a later ``dlopen``
    maps the new code). Returns its path; raises when ``g++`` is missing or
    fails."""
    out = host_lib_path()
    if force or not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
        proc = subprocess.run(["g++", *HOST_FLAGS, HOST_SRC, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ exited {proc.returncode} building {HOST_SRC}:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: no process sees half a library
    return out
