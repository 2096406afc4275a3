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
- ``libmesh_simplify.so``: the repository's ``native/mesh_simplify.cpp``
  (quadric edge-collapse decimation), the same way.

A library is rebuilt only when the SHA-256 of its sources and flags differs
from the stamp written beside it. The build writes to a temporary file and
renames it, so concurrent processes never load a half-written library.
"""

from __future__ import annotations

import collections
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
    # the kernels must round as separate IEEE products and sums, as their
    # plain versions do (see csrc/bvh_trace.cu, csrc/shade.cu, csrc/permuto.cu,
    # csrc/occupancy_sampler.cu, csrc/volrender.cu, csrc/bg_samples.cu,
    # csrc/sphere_trace.cu)
    "-fmad=false",
]
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of each source's launchers: source -> {name: (restype, argtypes)}
_KERNEL_SIGNATURES = {
    "scatter_add.cu": {"vs_scatter_add_rows": (_I, [_P, _P, _P, _LL, _I, _LL, _P])},
    "bvh_trace.cu": {
        "vs_bvh_trace": (_I, [_P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P]),
    },
    "permuto.cu": {
        "vs_permuto_forward": (_I, [_P] * 8 + [_LL, _I, _P]),
        "vs_permuto_backward": (_I, [_P] * 10 + [_LL, _I, _LL, _P]),
    },
    "occupancy_sampler.cu": {
        "vs_occupancy_samples": (_I, [_P] * 11 + [_F, _F, _F, _I, _I, _I, _I, _F, _I, _LL, _P]),
    },
    "volrender.cu": {
        "vs_combine_samples": (_I, [_P] * 9 + [_F] + [_P] * 5 + [_I, _I, _I, _LL, _P]),
        "vs_neus_transmittance_forward": (_I, [_P] * 5 + [_I, _LL, _P]),
        "vs_neus_transmittance_backward": (_I, [_P] * 7 + [_I, _LL, _P]),
        "vs_importance": (_I, [_P] * 5 + [_F, _P, _P, _I, _I, _I, _LL, _I, _P]),
    },
    "bg_samples.cu": {"vs_bg_samples": (_I, [_P] * 4 + [_F, _F] + [_P] * 5 + [_I, _LL, _P])},
    "sphere_trace.cu": {
        "vs_sphere_trace_step": (_I, [_P] * 17 + [_F, _F, _F, _I, _I, _F, _I] + [_F] * 8
                                 + [_LL, _P]),
    },
    "shade.cu": {
        "vs_shade_composite": (_I, [_P] * 10 + [_I, _I, _LL, _I, _P, _P, _P]),
        "vs_half_ops_check": (_I, [_P, _P, _LL, _P, _P]),
    },
}
_BVH_SIGNATURES = {
    "bvh_build_sah": (_I, [_P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P]),
}
_SIMPLIFY_SIGNATURES = {
    "mesh_simplify": (_I, [_P, _I, _P, _I, _I, _P, _P, _P]),
}

_LIBS: dict[str, object] = {}
_LOCK = threading.Lock()


class BuildError(RuntimeError):
    """A compiler run failed; the message carries its stderr."""


def _cuda_tool(name: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", name)
    return path if os.path.exists(path) else name


def _nvcc() -> str:
    return _cuda_tool("nvcc")


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


def mesh_simplifier() -> ctypes.CDLL:
    """The native quadric mesh simplifier (built with g++ on first use)."""
    src = os.path.join(_REPO_DIR, "native", "mesh_simplify.cpp")
    return _cached("mesh_simplify", lambda: _open(
        _build_all([("libmesh_simplify.so", ["g++"], GXX_FLAGS, [src])])[0],
        _SIMPLIFY_SIGNATURES))


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


# SASS opcodes counted apart by ``sass_counts``: global loads, the
# conversions between float32 and float16 or integers, the half2 and half
# arithmetic, and the byte permutes
_SASS_CLASSES = {
    "loads": ("LDG",),
    "conversions": ("F2F", "I2F", "F2I", "F2FP", "HADD2.F32"),
    "half_ops": ("HADD2", "HMUL2", "HFMA2"),
    "byte_permutes": ("PRMT",),
}


def _class_counts(ops) -> dict:
    counts = {"total": sum(ops.values())}
    for cls, prefixes in _SASS_CLASSES.items():
        counts[cls] = sum(
            n for op, n in ops.items()
            if any(op == p or op.startswith(p + ".") for p in prefixes)
            and not (cls == "half_ops" and op.startswith("HADD2.F32")))
    return counts


def sass_counts(lib_path: str | None = None) -> dict:
    """Static SASS instruction counts of each kernel in a built library (by
    default K4's), from ``cuobjdump -sass``: {kernel: {"total", "loads",
    "conversions", "half_ops", "byte_permutes", "loop", "by_opcode"}}.
    NOPs are not counted; ``conversions`` takes ``HADD2.F32`` (a float16 to
    float32 conversion on sm_90) and leaves it out of ``half_ops``.
    ``loop`` holds the same counts for the instructions of the kernel's
    longest loop (from the target of its longest backward branch to the
    branch): in K4 the loop over shells, whose body is one hit's work."""
    if lib_path is None:
        lib_path = os.path.join(BUILD_DIR, _kernel_lib_name("shade.cu"))
    sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    kernels, code = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            code = kernels.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*)", line)
        if m and code is not None and m.group(2) != "NOP":
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
    result = {}
    for name, code in kernels.items():
        ops = collections.Counter(op for _, op, _ in code)
        back = [(addr - int(t.group(1), 16), int(t.group(1), 16), addr)
                for addr, op, rest in code if op == "BRA"
                for t in [re.search(r"0x([0-9a-f]+)", rest)] if t and int(t.group(1), 16) < addr]
        _, first, last = max(back, default=(0, 0, -1))
        loop = collections.Counter(op for addr, op, _ in code if first <= addr <= last)
        result[name] = {**_class_counts(ops), "loop": _class_counts(loop),
                        "by_opcode": dict(ops.most_common())}
    return result


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless t is a contiguous tensor of dtype and shape on device,
    as a kernel's launcher takes it."""
    if (t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != tuple(shape)
            or t.device != device):
        raise ValueError(f"{name}: expected a contiguous {dtype} {tuple(shape)} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def check(status: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
