"""Builds the port's native libraries at first use and loads them with ctypes.

All are built into ``volsurfs_tpu_torch/_build/`` (git-ignored):

- one ``libvs_<name>.so`` per ``csrc/<name>.cu`` file, for ``sm_90a``, with
  a plain C interface (no PyTorch headers, so a build takes seconds). The
  ``nvcc`` calls run in parallel, one per source. Each C launcher returns
  ``cudaGetLastError()``. ``ptxas -v`` reports each kernel's registers and
  spills; its output is kept beside the library (``<lib>.log``) and read by
  ``kernel_resources``.
- ``libbvh_build.so``: the repository's ``native/bvh_build.cpp`` (binned-SAH
  BVH build), compiled with ``g++``. The source is read in place.

A library is rebuilt only when the SHA-256 of its sources and flags differs
from the stamp written beside it. The build writes to a temporary file and
renames it, so concurrent processes never load a half-written library.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import subprocess
import tempfile
import threading
import types

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_DIR = os.path.dirname(_PKG_DIR)
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # the trace kernel must round t, u, v as separate IEEE products and
    # sums, as its plain version does (see csrc/bvh_trace.cu)
    "-fmad=false",
]
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# C signatures of each source's launchers: source -> {name: (restype, argtypes)}
_KERNEL_SIGNATURES = {
    "scatter_add.cu": {"vs_scatter_add_rows": (_I, [_P, _P, _P, _LL, _I, _LL, _P])},
    "bvh_trace.cu": {
        "vs_bvh_trace": (_I, [_P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P]),
    },
}
_BVH_SIGNATURES = {
    "bvh_build_sah": (_I, [_P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P]),
}

_LIBS: dict[str, object] = {}
_LOCK = threading.Lock()


class BuildError(RuntimeError):
    """A compiler run failed; the message carries its stderr."""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _digest(sources, cmd) -> str:
    h = hashlib.sha256(" ".join(cmd).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _write_atomic(path: str, text: str) -> None:
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".", dir=BUILD_DIR)
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _build_all(jobs) -> list:
    """Compile each (name, compiler, flags, sources) job into BUILD_DIR/name
    unless its stamp matches; the compilers run in parallel. Returns the
    libraries' paths."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    for name, compiler, flags, sources in jobs:
        out = os.path.join(BUILD_DIR, name)
        digest = _digest(sources, compiler + flags)
        stamp = out + ".sha256"
        if os.path.exists(out) and os.path.exists(stamp):
            with open(stamp) as f:
                if f.read().strip() == digest:
                    continue
        fd, tmp = tempfile.mkstemp(prefix=name + ".", suffix=".tmp", dir=BUILD_DIR)
        os.close(fd)
        cmd = compiler + flags + ["-o", tmp] + sources
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((name, out, tmp, digest, cmd, proc))
    failures = []
    for name, out, tmp, digest, cmd, proc in running:
        stdout, stderr = proc.communicate()
        try:
            if proc.returncode != 0:
                failures.append(f"building {name} failed ({' '.join(cmd)}):\n{stderr}{stdout}")
                continue
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        _write_atomic(out + ".log", stderr + stdout)
        _write_atomic(out + ".sha256", digest)
    if failures:
        raise BuildError("\n".join(failures))
    return [os.path.join(BUILD_DIR, name) for name, _, _, _ in jobs]


def _open(path: str, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def kernel_sources() -> list:
    return sorted(glob.glob(os.path.join(_PKG_DIR, "csrc", "*.cu")))


def _kernel_lib_name(src: str) -> str:
    return "libvs_" + os.path.splitext(os.path.basename(src))[0] + ".so"


def _cached(key: str, load):
    """The loaded library ``key``; ``load()`` builds and loads it once."""
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    with _LOCK:
        if key not in _LIBS:
            _LIBS[key] = load()
        return _LIBS[key]


def _load_kernels() -> types.SimpleNamespace:
    sources = kernel_sources()
    paths = _build_all([(_kernel_lib_name(s), [_nvcc()], NVCC_FLAGS, [s]) for s in sources])
    ns = types.SimpleNamespace()
    for src, path in zip(sources, paths):
        signatures = _KERNEL_SIGNATURES[os.path.basename(src)]
        lib = _open(path, signatures)
        for fn in signatures:
            setattr(ns, fn, getattr(lib, fn))
    return ns


def kernels() -> types.SimpleNamespace:
    """The CUDA kernels' C launchers, as attributes (built with nvcc on
    first use, one library per source)."""
    return _cached("kernels", _load_kernels)


def bvh_builder() -> ctypes.CDLL:
    """The native SAH BVH builder (built with g++ on first use)."""
    src = os.path.join(_REPO_DIR, "native", "bvh_build.cpp")
    return _cached("bvh_build", lambda: _open(
        _build_all([("libbvh_build.so", ["g++"], GXX_FLAGS, [src])])[0], _BVH_SIGNATURES))


def kernel_resources() -> dict:
    """Each built kernel's registers per thread and spilled bytes, as
    ``ptxas -v`` reported them: {kernel name: {"registers", "spill_stores",
    "spill_loads"}}."""
    out = {}
    for src in kernel_sources():
        log = os.path.join(BUILD_DIR, _kernel_lib_name(src) + ".log")
        if not os.path.exists(log):
            continue
        name = None
        with open(log) as f:
            for line in f:
                # the kernels have C names (extern "C"), so none is mangled
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    name = m.group(1)
                    out[name] = {}
                    continue
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m and name:
                    out[name]["spill_stores"] = int(m.group(1))
                    out[name]["spill_loads"] = int(m.group(2))
                m = re.search(r"Used (\d+) registers", line)
                if m and name:
                    out[name]["registers"] = int(m.group(1))
    return out


def check(status: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
