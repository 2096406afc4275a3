"""Checkpoints of a ``Surf``, ``NeRF``, ``OffsetsSurfs`` or ``VolSurfs`` run
(counterpart of volsurfs_tpu/training/checkpoints.py), in the JAX package's
layout: ``<ckpt_dir>/<iter:07d>/models/`` holds one ``{name}.pt`` state
dict per module (``sdf``, ``rgb``; ``density``, ``rgb``; ``sdfs``,
``rgb_0``, ``alpha_0``; ``rgb_i``, ``alpha_i``) and ``train_state.pt``
with the optimizer, the learning-rate scheduler, ``iter_nr``, the state of
the trainer's batch generator and, where the method has them, its own
generator's state and its occupancy grid (values, occupancy, ROI,
extent), so that a resumed run draws the same rays and takes the same steps
as one that never stopped.

``load_jax_params`` carries the parameters of a JAX checkpoint
(``{name}.msgpack``, as ``flax.serialization.to_bytes`` writes them) into
the port's modules. It decodes the msgpack subset flax writes with a
reader of its own, since neither ``msgpack`` nor ``flax`` is needed here.
"""

from __future__ import annotations

import os
import shutil
import struct

import numpy as np
import torch

from volsurfs_tpu_torch.convert import params_from_jax
from volsurfs_tpu_torch.ops.occupancy import OccupancyGrid

TRAIN_STATE = "train_state.pt"


def _iter_dir(ckpt_dir: str, iter_nr: int) -> str:
    return os.path.join(ckpt_dir, f"{iter_nr:07d}", "models")


def save_checkpoint(ckpt_dir: str, method, batch_generator: torch.Generator | None = None,
                    keep_previous: bool = False) -> str:
    """Save under <ckpt_dir>/<iter:07d>/models/; without keep_previous the
    other iteration folders are deleted. Returns the folder."""
    iter_nr = int(method.iter_nr)
    out = _iter_dir(ckpt_dir, iter_nr)
    os.makedirs(out, exist_ok=True)
    for name, module in method.models.items():
        torch.save(module.state_dict(), os.path.join(out, f"{name}.pt"))
    aux = {
        "optimizer": method.optimizer.state_dict(),
        "scheduler": method.scheduler.state_dict(),
        "iter_nr": iter_nr,
    }
    if batch_generator is not None:
        aux["batch_generator"] = batch_generator.get_state()
    if getattr(method, "generator", None) is not None:
        aux["method_generator"] = method.generator.get_state()
    grid = getattr(method, "grid", None)
    if grid is not None:
        aux["grid"] = {"values": grid.values.cpu(), "occupancy": grid.occupancy.cpu(),
                       "roi": grid.roi.cpu(), "extent": torch.tensor(grid.extent)}
    torch.save(aux, os.path.join(out, TRAIN_STATE))

    if not keep_previous:
        for entry in sorted(os.listdir(ckpt_dir)):
            full = os.path.join(ckpt_dir, entry)
            if entry.isdigit() and int(entry) != iter_nr and os.path.isdir(full):
                shutil.rmtree(full)
    return out


def get_last_checkpoint_in_path(ckpt_dir: str):
    """Latest iteration folder's number, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    iters = [int(d) for d in os.listdir(ckpt_dir) if d.isdigit()]
    if not iters:
        return None
    return max(iters)


def _resolve_iter(ckpt_dir: str, iter_nr):
    if iter_nr is None:
        iter_nr = get_last_checkpoint_in_path(ckpt_dir)
        if iter_nr is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return iter_nr


def load_checkpoint(ckpt_dir: str, method, batch_generator: torch.Generator | None = None,
                    iter_nr: int | None = None):
    """Restore method (modules, optimizer, scheduler, iter_nr) in place
    from the checkpoint of iter_nr (the latest if None), and the batch
    generator's state if one is given. Returns method."""
    src = _iter_dir(ckpt_dir, _resolve_iter(ckpt_dir, iter_nr))
    for name, module in method.models.items():
        state = torch.load(os.path.join(src, f"{name}.pt"), map_location="cpu",
                           weights_only=True)
        module.load_state_dict(state)
    # loaded on the host: the optimizer moves its moments to the parameters'
    # device and keeps Adam's step counts on the host, as it makes them
    aux = torch.load(os.path.join(src, TRAIN_STATE), map_location="cpu", weights_only=True)
    method.optimizer.load_state_dict(aux["optimizer"])
    method.scheduler.load_state_dict(aux["scheduler"])
    method.iter_nr = int(aux["iter_nr"])
    if batch_generator is not None and "batch_generator" in aux:
        batch_generator.set_state(aux["batch_generator"])
    if "method_generator" in aux:
        method.generator.set_state(aux["method_generator"])
    if "grid" in aux:
        g, dev = aux["grid"], method.device
        method.grid = OccupancyGrid(g["values"].to(dev), g["occupancy"].to(dev),
                                    g["roi"].to(dev), tuple(g["extent"].tolist()))
    return method


# ---- JAX checkpoints ---------------------------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3  # flax.serialization's ext type codes


class _MsgpackReader:
    """Decodes the msgpack that flax.serialization writes: maps, arrays,
    strings, binaries, nil, booleans, integers, floats, and the ext types
    for ndarrays and numpy scalars (each a msgpack (shape, dtype name,
    bytes) triple)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: data ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self._unpack(fmt)
            if kind == "bin":
                return self._take(n)
            if kind == "str":
                return self._take(n).decode()
            if kind == "array":
                return self._array(n)
            if kind == "map":
                return self._map(n)
            return self._ext(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self._ext(1 << (b - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self._unpack(numbers[b])
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def _array(self, n: int):
        return [self.read() for _ in range(n)]

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, n: int):
        code = self._unpack(">b")
        payload = self._take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, dtype, buf = _MsgpackReader(payload).read()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree):
    """flax splits arrays above 1 GiB into chunks; put them back."""
    if not isinstance(tree, dict):
        return tree
    if tree.get("__msgpack_chunked_array__"):
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path: str):
    """A file written by flax.serialization.to_bytes as a nested dict of
    numpy arrays."""
    with open(path, "rb") as f:
        data = f.read()
    reader = _MsgpackReader(data)
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{path}: {len(data) - reader.pos} bytes after the msgpack object")
    return _unchunk(tree)


def load_jax_params(ckpt_dir: str, method, iter_nr: int | None = None):
    """Load the parameters of a JAX surf, nerf, offsets_surfs or volsurfs checkpoint
    (``<ckpt_dir>/<iter:07d>/models/{name}.msgpack`` for each of the
    method's modules; the latest iteration if iter_nr is None) into
    method's modules through ``convert.params_from_jax``. Only parameters
    are carried: the optimizer, the scheduler, the grid and ``iter_nr`` stay
    as they are (a fresh method starts its schedule at 0). Returns
    method."""
    src = _iter_dir(ckpt_dir, _resolve_iter(ckpt_dir, iter_nr))
    params = {name: read_flax_msgpack(os.path.join(src, f"{name}.msgpack"))
              for name in method.models}
    for name, state in params_from_jax(params).items():
        method.models[name].load_state_dict(state)
    return method
