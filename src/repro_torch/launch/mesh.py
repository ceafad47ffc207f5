"""Mesh builders: the port of ``repro.launch.mesh``.

Each builder returns a ``torch.distributed.device_mesh.DeviceMesh`` with
the reference's axis names and shapes, over the first ranks of the default
process group, laid out row-major as ``jax.make_mesh`` lays out devices.
Single-pod: (16, 16) = 256 ranks, axes ("data", "model").  Multi-pod:
(2, 16, 16) = 512 ranks, axes ("pod", "data", "model"); "pod" is the slow
(cross-pod) axis used for cross-pod data parallelism or pipeline stages.

Like every entry point of the port they run on the card unless the caller
names another device: ``device=None`` is ``cuda`` with NCCL
(:func:`repro_torch.device.resolve` raises without a card), ``"cpu"`` is
gloo.  The caller starts the ranks and initialises the group
(``torch.distributed.init_process_group`` with a store, the world size and
each rank's number, or :func:`run_ranks`, which spawns them); only
:func:`make_host_mesh` starts a group itself, a one-rank one over a
``FileStore`` in a temporary directory when none exists, so that one card
is a host mesh ``("data",)`` of 1.
"""
from __future__ import annotations

import atexit
import datetime
import math
import os
import shutil
import tempfile
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import DeviceLike, resolve

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
PRODUCTION_WORLDS = (256, 512)


def backend_for(device: DeviceLike = None) -> str:
    """The process-group backend of a device: NCCL on the card, gloo on
    the CPU."""
    return BACKENDS[resolve(device).type]


def init_local_group(device: DeviceLike = None) -> bool:
    """Start a one-rank process group over a ``FileStore`` in a temporary
    directory (removed at exit) when none exists; True if it started
    one."""
    if dist.is_initialized():
        return False
    backend = backend_for(device)
    if backend == "nccl":       # the rank's card, before any communicator
        torch.cuda.set_device(torch.cuda.current_device())
    tmp = tempfile.mkdtemp(prefix="repro_torch_group_")
    atexit.register(shutil.rmtree, tmp, True)
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return True


def _mesh(shape: Sequence[int], axes: Sequence[str],
          device: DeviceLike) -> DeviceMesh:
    dev = resolve(device)
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {tuple(shape)} needs a process group of {need} "
            f"ranks: call torch.distributed.init_process_group first")
    if device is None and dev.type == "cuda" and dist.get_backend() == "gloo":
        # a card mesh over gloo moves its tensors through host memory:
        # only a caller who names the device gets one
        raise ValueError(
            "a cuda mesh (device=None) over a gloo group: pass "
            "device='cpu' for a host mesh, or device='cuda' to run card "
            "tensors over it")
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        from repro_torch.dist.collectives import stage_card_gathers
        stage_card_gathers()
    world = dist.get_world_size()
    if world < need:
        raise ValueError(f"a mesh of {tuple(shape)} needs {need} ranks, the "
                         f"process group has {world}")
    return DeviceMesh(dev.type, torch.arange(need).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``; a world of 256 or 512 ranks (a
    single-pod mesh takes the first 256 of 512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world not in PRODUCTION_WORLDS or world < math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{math.prod(shape)} (of {PRODUCTION_WORLDS}) "
                         f"ranks, the process group has {world}")
    return _mesh(shape, axes, device)


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model"),
                   device: DeviceLike = None) -> DeviceMesh:
    """A small mesh over the first ``prod(shape)`` ranks."""
    return _mesh(shape, axes, device)


def make_host_mesh(device: DeviceLike = None) -> DeviceMesh:
    """Every rank of the process group as a 1-D ``("data",)`` mesh; with no
    group, a one-rank group is started first (:func:`init_local_group`)."""
    init_local_group(device)
    return _mesh((dist.get_world_size(),), ("data",), device)


def _rank_main(rank: int, fn: Callable, world: int, store: str,
               backend: str, timeout_s: float, args: tuple) -> None:
    # the ranks share the host's cores: one share each, not all of them
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    if backend == "nccl":       # one card a rank
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args,
              backend: Optional[str] = None,
              timeout_s: float = 300.0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes, each a
    rank of one process group (``backend``, a ``FileStore`` in a temporary
    directory: no port, no network), each with its share of the host's
    cores for torch's CPU threads; a collective that waits longer than
    ``timeout_s`` raises.  ``backend=None`` is the card's, NCCL (one card
    a rank; it raises without a card); ``"gloo"`` runs the ranks on the
    CPU.  Returns when every rank has returned, and raises if one failed.
    ``fn`` must be importable by name (spawned processes import it
    afresh)."""
    import torch.multiprocessing as mp
    backend = backend or backend_for(None)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        mp.start_processes(
            _rank_main, args=(fn, world, os.path.join(tmp, "store"),
                              backend, timeout_s, args),
            nprocs=world, start_method="spawn")
