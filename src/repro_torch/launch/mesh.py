"""Meshes and the ranks behind them (port of repro/launch/mesh.py).

repro builds a jax Mesh over the devices one process sees. Here one process
drives one rank, so a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over an initialised process group, and ``spawn`` starts the ranks:

    results = spawn(fn, 2, backend="gloo")   # fn(rank, world, *args) in each

The backend is always the caller's choice, never switched behind its back:

  nccl   one card per rank (rank r on cuda:r); refused when the machine has
         fewer cards than ranks
  gloo   the CPU, or CUDA tensors of ranks that share cards (rank r on
         cuda:(r mod cards)); for CUDA tensors gloo carries broadcast and
         all_reduce only, which is all the tensor-parallel forward uses

repro's ``set_mesh`` and ``shard_map`` steer jit and have no counterpart.
"""

from __future__ import annotations

import math
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch

BACKENDS = ("nccl", "gloo")
# cards one NVLink / NVSwitch domain joins: an HGX H100 node
NVLINK_DOMAIN = 8


def make_mesh(shape, axes):
    """A DeviceMesh of ``shape`` named ``axes`` over the initialised default
    process group, one rank per point, row-major (the last axis varies
    fastest: consecutive ranks share a ``model`` group). Its device type is
    the backend's: cuda under nccl, cpu under gloo (whose ranks may hold
    CUDA tensors all the same; the forward never hands the mesh a tensor)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (launch.mesh.spawn "
                           "starts ranks with one)")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} ranks, the group has "
                         f"{dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


class MeshShape:
    """A mesh as the sharding rules read it (axis names and sizes), before
    any rank exists: the launchers check a --mesh with it in the parent."""

    def __init__(self, shape, axes):
        self.axis_names, self.shape = tuple(axes), dict(zip(axes, shape))


def make_production_mesh():
    """(data, model): ``model`` spans one node's NVLink domain of
    NVLINK_DOMAIN cards, ``data`` the nodes (world size / NVLINK_DOMAIN)."""
    import torch.distributed as dist
    world = dist.get_world_size()
    if world % NVLINK_DOMAIN:
        raise ValueError(f"a production mesh takes whole nodes of {NVLINK_DOMAIN} cards; "
                         f"the group has {world} ranks")
    return make_mesh((world // NVLINK_DOMAIN, NVLINK_DOMAIN), ("data", "model"))


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device rank ``rank`` computes on: cuda:(rank mod cards) for a
    CUDA device (a card per rank under NCCL; shared cards under gloo), else
    the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(fn, rank, world, backend, init, timeout, args, results):
    import torch.distributed as dist
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def spawn(fn, world: int, *, backend: str, args=(), timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method: CUDA does not survive a fork), each rank with
    the process group initialised and destroyed around it; -> the ranks'
    return values, by rank. The ranks meet at a file in a temporary
    directory of their own, never at a fixed port. A rank that raises or
    dies ends every rank and raises here with its traceback, as does
    ``timeout`` seconds passing (also each collective's limit)."""
    import multiprocessing as mp
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of {BACKENDS}")
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > cards:
            raise RuntimeError(f"nccl takes one card per rank: {world} ranks, {cards} "
                               "card(s) visible (ranks that share a card need "
                               "backend='gloo')")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, init, timeout, args, results))
             for r in range(world)]
    out, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world and failure is None:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode is not None and i not in out]
                if dead:
                    # a rank's error is queued before it exits: read it first
                    try:
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        failure = f"rank {dead[0]} died with exit code {procs[dead[0]].exitcode}"
                        break
                elif time.monotonic() > deadline:
                    failure = f"the ranks did not finish within {timeout} s"
                    break
                else:
                    continue
            if ok:
                out[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world)]
