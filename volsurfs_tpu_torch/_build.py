"""Builds the port's native libraries at first use and loads them with ctypes.

Two libraries, both built into ``volsurfs_tpu_torch/_build/`` (git-ignored):

- ``libvolsurfs_kernels.so``: every ``csrc/*.cu`` file in ONE ``nvcc`` call
  for ``sm_90a``, with a plain C interface (no PyTorch headers, so the
  build takes seconds). Each C launcher returns ``cudaGetLastError()``.
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
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_DIR = os.path.dirname(_PKG_DIR)
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # the trace kernel must round t, u, v as separate IEEE products and
    # sums, as its plain version does (see csrc/bvh_trace.cu)
    "-fmad=false",
]
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# C signatures: name -> (restype, argtypes)
_KERNEL_SIGNATURES = {
    "vs_scatter_add_rows": (_I, [_P, _P, _P, _LL, _I, _LL, _P]),
    "vs_bvh_trace": (
        _I, [_P, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P],
    ),
}
_BVH_SIGNATURES = {
    "bvh_build_sah": (_I, [_P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P]),
}

_LIBS: dict[str, ctypes.CDLL] = {}
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


def _build(name: str, compiler: list, flags: list, sources: list) -> str:
    """Compile ``sources`` into BUILD_DIR/name unless its stamp matches."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, name)
    stamp = out + ".sha256"
    digest = _digest(sources, compiler + flags)
    if os.path.exists(out) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return out
    fd, tmp = tempfile.mkstemp(prefix=name + ".", suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            compiler + flags + ["-o", tmp] + sources,
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise BuildError(
                f"building {name} failed ({' '.join(compiler + flags)}):\n"
                f"{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    fd, tmp_stamp = tempfile.mkstemp(prefix=name + ".", suffix=".stamp", dir=BUILD_DIR)
    with os.fdopen(fd, "w") as f:
        f.write(digest)
    os.replace(tmp_stamp, stamp)
    return out


def _load(name: str, make_args) -> ctypes.CDLL:
    """The loaded library ``name``; on first use, ``make_args()`` gives
    (compiler, flags, sources, signatures) and the library is built."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            compiler, flags, sources, signatures = make_args()
            lib = ctypes.CDLL(_build(name, compiler, flags, sources))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[name] = lib
        return lib


def kernel_sources() -> list:
    return sorted(glob.glob(os.path.join(_PKG_DIR, "csrc", "*.cu")))


def kernels() -> ctypes.CDLL:
    """The CUDA kernel library (built with nvcc on first use)."""
    return _load(
        "libvolsurfs_kernels.so",
        lambda: ([_nvcc()], NVCC_FLAGS, kernel_sources(), _KERNEL_SIGNATURES),
    )


def bvh_builder() -> ctypes.CDLL:
    """The native SAH BVH builder (built with g++ on first use)."""
    src = os.path.join(_REPO_DIR, "native", "bvh_build.cpp")
    return _load("libbvh_build.so", lambda: (["g++"], GXX_FLAGS, [src], _BVH_SIGNATURES))


def check(status: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
