"""Meshes of ranks and the logical-to-mesh sharding rules (counterpart of
``repro.launch.mesh``).

The port is SPMD: one process per rank, joined by ``torch.distributed``.
``init_rank`` joins a process to its group at an explicit address
(nothing on the machine names a cluster), ``make_mesh`` builds a
``DeviceMesh`` with named dims over that group, and ``spawn`` starts the
ranks of one host and joins them within a time limit. The collective
backend is always the caller's: ``nccl`` when each rank has its own card,
``gloo`` on the CPU and for ranks that share one card. Nothing switches
backend on its own, and a mesh that cannot be built raises.

The reference's production pod shapes are TPU facts and are not copied:
the mesh shape is an argument. ``dry_mesh`` gives the dry run
(``launch.dryrun``) one rank of a mesh of any shape in one process, over
PyTorch's fake process group: its collectives return at once and move
nothing, so a step on ``meta`` tensors runs as that rank's would.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import socket
import time
from datetime import timedelta
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def free_port() -> int:
    """A free TCP port on localhost for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_backend(backend: str, device: torch.device, n: int) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown collective backend {backend!r}; pass one "
                         f"of {BACKENDS}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend runs on CUDA devices; use "
                             "'gloo' for ranks on the CPU")
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < n:
            raise RuntimeError(
                f"the nccl backend puts one rank on each card: {n} ranks "
                f"need {n} cards, found {found}; pass backend 'gloo' "
                "(--dist-backend gloo) for ranks that share a card")


def init_rank(rank: int, world: int, port: int, *, backend: str,
              device="cuda", timeout_s: float = 300.0) -> torch.device:
    """Join rank ``rank`` of ``world`` to the default process group at
    ``tcp://127.0.0.1:<port>`` on ``backend``; returns the rank's device
    (``cuda:<rank mod cards>``: its own card under nccl, the shared one
    under gloo on a single card; or the CPU)."""
    device = torch.device(device)
    check_backend(backend, device, world)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' for ranks on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return device


def make_mesh(n: Union[int, Sequence[int]],
              axes: Tuple[str, ...] = ("model",), *, device="cuda",
              backend: str):
    """A ``DeviceMesh`` of shape ``n`` with dims named ``axes`` over the
    default process group, which must run ``backend`` with exactly that
    many ranks (``init_rank``)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (int(n),) if isinstance(n, int) else tuple(int(d) for d in n)
    axes = tuple(axes)
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    device = torch.device(device)
    check_backend(backend, device, math.prod(shape))
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: this process has joined no group; "
                           "call launch.mesh.init_rank first")
    have = dist.get_backend()
    if have != backend:
        raise RuntimeError(f"make_mesh: the process group runs {have!r}, "
                           f"the mesh asks for {backend!r}")
    if dist.get_world_size() != math.prod(shape):
        raise RuntimeError(f"make_mesh: a mesh of shape {shape} needs "
                           f"{math.prod(shape)} ranks, the group has "
                           f"{dist.get_world_size()}")
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def batch_axes(mesh) -> Tuple[str, ...]:
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    return tuple(a for a in ("pod", "data") if a in names)


def sharding_rules(mesh, *, fsdp: bool = False) -> Dict[str, object]:
    """Logical-axis rules consumed by ``nn.module.resolve_pspec``: tensor
    parallel over ``model`` (heads, mlp, vocab, experts); with ``fsdp``
    the embed axis of weights also over the batch axes."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    b = batch_axes(mesh)
    model = "model" if "model" in names else None
    return {"batch": b, "vocab": model, "heads": model, "mlp": model,
            "experts": model, "embed": b if fsdp else None}


def expert_parallel_rules(mesh) -> Dict[str, object]:
    """``sharding_rules`` with the experts over ``model`` and every other
    weight axis whole: the placement of a raw tree whose only parallelism
    is the expert-parallel MoE (the serving and routing callers that keep
    the dense weights replicated)."""
    return {**sharding_rules(mesh), "heads": None, "mlp": None,
            "vocab": None}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dim names and ranks with no process behind it: what
    ``launch.cells.build_cell`` needs to resolve placements with nothing
    allocated and no group joined (``DeviceMesh`` answers the same
    ``mesh_dim_names`` and ``shape``)."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def parse_mesh(text: str) -> MeshShape:
    """A mesh record from ``"16x16"`` ((data, model)), ``"2x16x16"``
    ((pod, data, model)) or ``"1"`` (one device, (1, 1)): the dry run's
    ``--mesh``."""
    dims = tuple(int(d) for d in text.lower().split("x"))
    if len(dims) == 1:
        dims = (1, dims[0])
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(dims))
    if names is None or min(dims) < 1:
        raise ValueError(f"mesh {text!r}: give DxM or PxDxM ranks, or 1")
    return MeshShape(dims, names)


@contextlib.contextmanager
def dry_mesh(shape: MeshShape):
    """Rank 0 of a ``DeviceMesh`` of ``shape`` with no ranks behind it:
    this process joins PyTorch's fake process group (``FakeStore``, the
    ``"fake"`` backend) as rank 0 of ``prod(shape)``, whose collectives
    return at once and move nothing (their outputs keep their shapes: on
    ``meta`` tensors nothing else is there). The group is torn down on
    exit, whatever happens inside, so no later code in the process
    inherits it. A process that has joined a group already raises."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dry_mesh: this process has joined a process "
                           "group already; run the dry run in a process of "
                           "its own")
    world = math.prod(shape.shape)
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    try:
        yield init_device_mesh("cpu", tuple(shape.shape),
                               mesh_dim_names=tuple(shape.mesh_dim_names))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, args: tuple = (), *,
          timeout_s: Optional[float] = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``n`` spawned processes and join them
    within ``timeout_s`` (None: no limit): a rank that raises re-raises
    here, and ranks that hang past the limit are killed and raise
    ``TimeoutError``."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=n, join=False,
                             start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while not ctx.join(timeout=5.0 if deadline is None else max(
            0.1, min(5.0, deadline - time.monotonic()))):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
            raise TimeoutError(f"{n} ranks did not end within "
                               f"{timeout_s:.0f} s")
