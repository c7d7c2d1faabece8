"""Fault-tolerant checkpoints of tensor trees (counterpart of
``repro.checkpoint.ckpt``), in the reference's on-disk format, so either
package reads what the other wrote.

Layout: ``<dir>/step_<N:08d>/`` holds ``manifest.json`` and one
``leaf_<i:05d>.npy`` per leaf. A leaf file is the leaf's raw bytes as a
1-D uint8 array; the manifest maps each leaf's tree path (dict keys
joined by "/", list items as ``__<i>``) to its file, shape and logical
dtype string, and records leafless containers under ``empty``.

Atomicity: leaves and manifest go to ``step_N.tmp/``, and the directory
is renamed to ``step_N/`` only after the manifest is fsynced, so a crash
mid-save never hides the newest complete checkpoint.

Logical dtypes are decoded without ``ml_dtypes``: ``bfloat16`` from its
bits, and ``int4`` (one byte per value, the low nibble in two's
complement, as ``ml_dtypes`` stores it) into int8 holding [-8, 7], the
port's dense int4. Dense int4 leaves are written back as ``int4`` when
wrapped in ``Int4``.

``CheckpointManager(async_save=True)`` snapshots the tree to host memory
on the caller's thread and writes it on a background thread.

A tree placed over a mesh of ranks is written whole, once (the mesh's rank
0), in the same format; ``restore(..., shardings=)`` reads each rank's
block of it onto any mesh.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import re
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device, tree_leaves

_LIST_KEY = re.compile(r"^__\d+$")


@dataclasses.dataclass(frozen=True)
class Int4:
    """A dense int4 leaf, held as an int8 tensor in [-8, 7] (torch has no
    int4); saved under the logical dtype ``int4``."""
    data: torch.Tensor


# ---------------------------------------------------------------------------
# leaf encoding
# ---------------------------------------------------------------------------

def _encode_leaf(leaf):
    """(uint8 raw bytes, shape, logical dtype string) of a leaf: a tensor,
    an ``Int4``, a numpy array or a Python scalar."""
    if isinstance(leaf, Int4):
        t = leaf.data.detach().cpu().contiguous()
        if t.dtype != torch.int8:
            raise TypeError(f"Int4 holds int8 data, got {t.dtype}")
        raw = (t.numpy().astype(np.int16) & 0xF).astype(np.uint8)
        return raw.reshape(-1), list(t.shape), "int4"
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _raw(t.view(torch.int16).numpy()), list(t.shape), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return _raw(arr), list(arr.shape), str(arr.dtype)


def _raw(arr: np.ndarray) -> np.ndarray:
    """The C-order bytes of ``arr`` as a 1-D uint8 array: a view where
    ``arr`` is C-contiguous (no copy of a large leaf), else a copy."""
    if arr.flags.c_contiguous:
        return arr.reshape(-1).view(np.uint8)
    return np.frombuffer(arr.tobytes(), np.uint8)


def _storage(raw: np.ndarray, dtype: str, shape) -> np.ndarray:
    """A view (no copy; ``raw`` may be memory-mapped) of a leaf's raw bytes
    in its storage dtype and shape: int16 bits for ``bfloat16``, one byte
    a value for ``int4``."""
    shape = tuple(int(s) for s in shape)
    if dtype == "bfloat16":
        return raw.view(np.int16).reshape(shape)
    if dtype == "int4":
        return raw.reshape(shape)
    try:
        return raw.view(np.dtype(dtype)).reshape(shape)
    except TypeError:
        raise ValueError(f"leaf dtype {dtype!r} cannot be decoded without "
                         "ml_dtypes (decoded: numpy dtypes, bfloat16, "
                         "int4)") from None


def _decoded(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """The tensor of a storage-dtype array (a copy of its own)."""
    arr = np.array(arr)
    if dtype == "bfloat16":
        return torch.from_numpy(arr).view(torch.bfloat16)
    if dtype == "int4":
        return torch.from_numpy((((arr & 0xF) ^ 8).astype(np.int16)
                                 - 8).astype(np.int8))
    return torch.from_numpy(arr)


def decode_leaf(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """The tensor (on the CPU) that ``_encode_leaf`` gave ``raw`` for: raw
    little-endian bytes of a logical ``dtype``. ``bfloat16`` keeps its
    bits; ``int4`` becomes int8 in [-8, 7]."""
    raw = np.frombuffer(np.asarray(raw).tobytes(), np.uint8)
    shape = tuple(int(s) for s in shape)
    if dtype == "bfloat16":
        bits = torch.from_numpy(raw.view(np.int16).copy())
        return bits.view(torch.bfloat16).reshape(shape)
    if dtype == "int4":
        vals = (((raw & 0xF) ^ 8).astype(np.int16) - 8).astype(np.int8)
        return torch.from_numpy(vals.reshape(shape))
    try:
        np_dtype = np.dtype(dtype)
    except TypeError:
        raise ValueError(f"leaf dtype {dtype!r} cannot be decoded without "
                         "ml_dtypes (decoded: numpy dtypes, bfloat16, "
                         "int4)") from None
    return torch.from_numpy(raw.view(np_dtype).reshape(shape).copy())


# ---------------------------------------------------------------------------
# tree paths
# ---------------------------------------------------------------------------

def _flatten(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            if isinstance(k, str) and _LIST_KEY.match(k):
                # '__<i>' is the reserved list encoding; a dict using it
                # would come back from restore_tree as a list
                raise ValueError(
                    f"dict key {k!r} at {path or '<root>'} collides with "
                    "the reserved list encoding '__<index>'; rename it")
            yield from _flatten(tree[k], f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}/__{i}")
    else:
        yield path, tree


def _empty_containers(tree, path=""):
    """Paths of leafless containers, which ``_flatten`` does not see."""
    if isinstance(tree, dict):
        if not tree:
            yield path, "dict"
        for k in sorted(tree):
            yield from _empty_containers(tree[k],
                                         f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (tuple, list)):
        if not tree:
            yield path, "list"
        for i, v in enumerate(tree):
            yield from _empty_containers(v, f"{path}/__{i}")


def _unflatten_into(like, flat: Dict[str, torch.Tensor], path=""):
    if isinstance(like, dict):
        return {k: _unflatten_into(like[k], flat,
                                   f"{path}/{k}" if path else str(k))
                for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten_into(v, flat, f"{path}/__{i}")
                          for i, v in enumerate(like))
    return flat[path]


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _mesh_of(tree):
    """The mesh of the first placed leaf of ``tree`` (None without one)."""
    from repro_torch.core import colshard
    return next((x.device_mesh for x in tree_leaves(tree)
                 if colshard.is_col_sharded(x)), None)


def _writes(mesh) -> bool:
    """Whether this rank writes a checkpoint of a tree placed on ``mesh``:
    the rank at coordinate 0 on every mesh dim (every rank without one)."""
    return mesh is None or all(c == 0 for c in mesh.get_coordinate())


def _barrier(mesh, device) -> None:
    """Every rank of ``mesh`` reaches this before any leaves it (a sum of
    one element over every mesh dim)."""
    from repro_torch.core import colshard
    colshard.all_reduce(torch.zeros(1, device=device), mesh,
                        tuple(mesh.mesh_dim_names))


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Write ``tree`` as checkpoint ``step`` atomically; returns its path.
    A tree with placed leaves (``nn.module.shard_params``, the optimizer
    state of a placed tree) is gathered whole (a collective: every rank
    of its mesh calls ``save``), written once, by the mesh's rank 0, in
    the reference's format, and every rank waits for the write."""
    mesh = _mesh_of(tree)
    if mesh is None:
        return _write(ckpt_dir, step, tree)
    device = next(x for x in tree_leaves(tree)
                  if isinstance(x, torch.Tensor)).device
    path = _write(ckpt_dir, step, tree, writes=_writes(mesh))
    _barrier(mesh, device)
    return path


def _write(ckpt_dir: str, step: int, tree: Any, writes: bool = True) -> str:
    """Write ``tree`` leaf by leaf. A placed leaf is gathered whole on the
    writing rank's host first (``colshard.gather_first``, a collective), so
    every rank of its mesh walks the tree; only the rank that ``writes``
    touches the files, and it holds one whole leaf at a time."""
    from repro_torch.core import colshard
    final = _step_dir(ckpt_dir, step)
    if not writes:
        for _, leaf in _flatten(tree):
            colshard.gather_first(leaf)
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}}
    for i, (path, leaf) in enumerate(_flatten(tree)):
        leaf = colshard.gather_first(leaf)
        raw, shape, dtype = _encode_leaf(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), raw)
        manifest["leaves"][path] = {"file": fname, "shape": shape,
                                    "dtype": dtype}
    empty = dict(_empty_containers(tree))
    if empty:
        manifest["empty"] = empty
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(ckpt_dir: str):
    """Steps of the ``step_N`` directories (``.tmp`` ones not)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(n[5:]) for n in os.listdir(ckpt_dir)
            if n.startswith("step_") and not n.endswith(".tmp")]


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete checkpoint's step: one whose manifest landed."""
    steps = [s for s in _steps(ckpt_dir) if os.path.exists(
        os.path.join(_step_dir(ckpt_dir, s), "manifest.json"))]
    return max(steps) if steps else None


def _load_leaves(ckpt_dir: str, step: Optional[int], device: torch.device):
    """({manifest path: tensor on ``device``}, {path: kind} of empty
    containers) of ``step``, the newest when it is None."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for p, meta in manifest["leaves"].items():
        raw = np.load(os.path.join(path, meta["file"]))
        flat[p] = decode_leaf(raw, meta["dtype"], meta["shape"]).to(device)
    return flat, manifest.get("empty", {})


def restore_tree(ckpt_dir: str, step: Optional[int] = None, *,
                 device=None) -> Any:
    """Restore a checkpoint without a template: the nested dict/list
    structure is rebuilt from the manifest paths (``__<i>`` keys, when
    exactly 0..n-1, become a list), leafless containers included. Leaves
    are tensors on ``device`` (``cuda`` unless ``"cpu"``)."""
    flat, empty = _load_leaves(ckpt_dir, step, resolve_device(device))
    root: Dict[str, Any] = {}
    for p, leaf in flat.items():
        parts = p.split("/")
        if parts and parts[0] == "":
            parts = parts[1:]   # '/__0'-style paths: the root is a list
        if not parts:
            return leaf         # the tree is this one leaf
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    for p, kind in empty.items():
        placeholder: Any = {} if kind == "dict" else []
        if p == "":
            return placeholder  # the whole tree is one empty container
        parts = [q for q in p.split("/") if q != ""]
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = placeholder

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.startswith("__") for k in out):
            try:
                nums = sorted(int(k[2:]) for k in out)
            except ValueError:
                return out
            if nums == list(range(len(out))):
                return [out[f"__{i}"] for i in range(len(out))]
        return out

    return listify(root)


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            shardings: Any = None, *, device=None, mesh=None) -> Any:
    """Restore into the structure of ``like``, leaves on ``device``
    (``cuda`` unless ``"cpu"``). ``shardings`` (a tree matching ``like``
    of per-mesh-dim placements, as ``launch.cells.build_cell`` gives them;
    a None subtree restores whole) puts each leaf on this rank's block of
    ``mesh`` (else the session mesh): the leaf file is memory-mapped and
    only the block is read and copied to the device, so a checkpoint
    written on one mesh (or by the reference) restores onto another."""
    dev = resolve_device(device)
    if shardings is None:
        flat, _ = _load_leaves(ckpt_dir, step, dev)
        return _unflatten_into(like, flat)
    if mesh is None:
        from repro_torch.nn.module import current_mesh
        mesh = current_mesh()
    path, manifest = _manifest(ckpt_dir, step)
    return _placed_into(like, shardings, manifest["leaves"], path, mesh, dev)


def _manifest(ckpt_dir: str, step: Optional[int]):
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, "manifest.json")) as f:
        return path, json.load(f)


def _placed_into(like, shardings, leaves: Dict, path: str, mesh, dev,
                 key: str = ""):
    from repro_torch.nn.module import is_placements
    if isinstance(like, dict):
        return {k: _placed_into(
            like[k], None if shardings is None else shardings.get(k),
            leaves, path, mesh, dev, f"{key}/{k}" if key else str(k))
            for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(_placed_into(
            v, None if shardings is None else shardings[i], leaves, path,
            mesh, dev, f"{key}/__{i}") for i, v in enumerate(like))
    if shardings is not None and not is_placements(shardings):
        raise ValueError(f"shardings at {key or '<root>'} do not match a "
                         f"leaf: {shardings!r}")
    if shardings is not None and mesh is None:
        raise ValueError(f"restore: {key or '<root>'} has placements "
                         f"{shardings}, and no mesh to place it on: pass "
                         "mesh=, or run under nn.module.session_mesh")
    return _read_block(path, leaves[key], shardings, mesh, dev)


def _read_block(path: str, meta: Dict, placements, mesh, dev):
    """A leaf file's block under ``placements`` on ``mesh``, as the placed
    leaf (``core.colshard.placed``) or, unsplit, the whole tensor."""
    from repro_torch.core import colshard
    from repro_torch.nn.module import block_dims
    raw = np.load(os.path.join(path, meta["file"]), mmap_mode="r")
    arr = _storage(raw, meta["dtype"], meta["shape"])
    dims = block_dims(placements, arr.shape, mesh)
    index = [slice(None)] * arr.ndim
    for d, axes in dims.items():
        n, i = colshard.batch_shard(mesh, axes)
        w = arr.shape[d] // n
        index[d] = slice(i * w, (i + 1) * w)
    block = _decoded(arr[tuple(index)], meta["dtype"]).to(dev)
    if not dims:
        return block
    return colshard.placed(block, mesh, colshard.placements_of(mesh, dims),
                           arr.shape)


def _host_snapshot(tree):
    """A host copy of every tensor leaf, taken now (later in-place writes
    to the tree do not reach it). A card's leaves are copied into pinned
    host memory (the allocator keeps it for the next snapshot), several
    times faster than into fresh pageable memory."""
    if isinstance(tree, dict):
        return {k: _host_snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_snapshot(v) for v in tree]
    if isinstance(tree, Int4):
        return Int4(_host_snapshot(tree.data))
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            host = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True)
            return host.copy_(tree.detach())
        return tree.detach().to("cpu", copy=True)
    return np.array(tree)


class CheckpointManager:
    """``keep_n`` retention and optional asynchronous writes."""

    def __init__(self, ckpt_dir: str, keep_n: int = 3,
                 async_save: bool = True):
        self.ckpt_dir = ckpt_dir
        self.keep_n = keep_n
        self.async_save = async_save
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if async_save:
            self._start()

    def _start(self):
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree = item
            try:
                _write(self.ckpt_dir, step, host_tree)
                self._gc()
            except BaseException as e:   # raised by the next save() / wait()
                self._error = e

    def _gc(self):
        for s in sorted(_steps(self.ckpt_dir))[:-self.keep_n]:
            shutil.rmtree(_step_dir(self.ckpt_dir, s), ignore_errors=True)

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any):
        """Snapshot ``tree`` to host memory now; write it now, or on the
        background thread when ``async_save``. A placed tree is written
        now, whatever ``async_save``: gathered leaf by leaf on every rank of
        its mesh (a collective), written by the mesh's rank 0 alone, and
        every rank returns once the files are complete."""
        self._raise_pending()
        mesh = _mesh_of(tree)
        if mesh is not None:
            # gathered leaf by leaf and written now, by the mesh's rank 0
            save(self.ckpt_dir, step, tree)
            if _writes(mesh):
                self._gc()
            return
        host_tree = _host_snapshot(tree)
        if self.async_save:
            self._q.put((step, host_tree))
        else:
            _write(self.ckpt_dir, step, host_tree)
            self._gc()

    def wait(self):
        """Drain pending asynchronous writes; raises a write's error."""
        if self._worker is not None:
            self._q.put(None)
            self._worker.join()
            self._start()
        self._raise_pending()

    def latest_step(self) -> Optional[int]:
        return latest_step(self.ckpt_dir)

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None, *, device=None, mesh=None) -> Any:
        return restore(self.ckpt_dir, like, step, shardings, device=device,
                       mesh=mesh)
