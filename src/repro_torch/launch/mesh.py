"""Mesh construction over the running ``torch.distributed`` process group.

A mesh here is a ``DeviceMesh`` over ranks, one device a rank: gloo for
CPU ranks, NCCL for CUDA ranks (never one for the other). Functions, not
module constants: importing this module touches no process group.

    python -m repro_torch.launch.serve --arch qwen2-72b --smoke \\
        --device cpu --page-size 8 --kv-bits 8 --tp 2   # 2 gloo ranks
"""
from __future__ import annotations

import math
import os
import pickle
import socket
import tempfile
import time
from typing import Tuple

import torch
import torch.distributed as dist

from .. import resolve_device


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(rank: int, world_size: int, port: int,
                       device="cuda") -> torch.device:
    """Join (or, at rank 0, open) a process group on
    ``tcp://localhost:<port>``: gloo for ``device`` "cpu", NCCL for a
    card, with rank r on card r. Returns this rank's device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = resolve_device(f"cuda:{rank % torch.cuda.device_count()}")
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank)
    return dev


def close_process_group() -> None:
    """Tear the running group down in order: every rank past a barrier,
    then every rank but 0, then rank 0, which hosts the rendezvous store
    (a rank that outlives the store's host can abort in its teardown)."""
    store = dist.distributed_c10d._get_default_store()
    rank, world = dist.get_rank(), dist.get_world_size()
    dist.barrier()
    if rank:
        dist.destroy_process_group()
        store.add("closed", 1)
        return
    while store.add("closed", 0) < world - 1:
        time.sleep(0.01)
    dist.destroy_process_group()


def spawn_ranks(fn, n: int, *args, device="cuda") -> list:
    """Run ``fn(rank, *args)`` on ``n`` spawned ranks of one process group
    on a free localhost port (gloo for ``device`` "cpu", NCCL for cards)
    and return the ranks' results in rank order. Each rank tears the
    group down through :func:`close_process_group` before it hands its
    result back; a rank that raises or dies ends the others and raises
    here (``torch.multiprocessing.spawn``)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_entry, args=(fn, n, free_port(), device, tmp, args),
                 nprocs=n, join=True)
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def _rank_entry(rank, fn, n, port, device, tmp, args):
    torch.set_num_threads(1)
    init_process_group(rank, n, port, device)
    result = fn(rank, *args)
    close_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _device_type(device) -> str:
    return torch.device(device).type


def _running_world(device) -> int:
    """Ranks of the running group; with none running, one on the CPU and
    the visible cards on CUDA (the reference counts visible devices)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if _device_type(device) == "cuda":
        resolve_device("cuda")
        return torch.cuda.device_count()
    return 1


def _ensure_group(device) -> None:
    """A one-rank group when none is running (a world of one device)."""
    if not dist.is_initialized():
        init_process_group(0, 1, free_port(), device)


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's (16, 16) / (2, 16, 16) TPU pod layouts are laid out
    by its dry run, which comes with ROADMAP queue A item 13 part 5."""
    raise NotImplementedError(
        "the production mesh (the dry run's 256 / 512-device layouts) is "
        "not ported yet: ROADMAP queue A item 13")


def make_host_mesh(device="cuda"):
    """The running group as a 1-D data mesh (one rank when none runs)."""
    _ensure_group(device)
    return _mesh((dist.get_world_size(),), ("data",), device)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), device="cpu"):
    """A small mesh over a running group of exactly prod(shape) ranks
    (spawned gloo ranks in the tests)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    want = math.prod(shape)
    if n != want:
        raise ValueError(f"mesh {tuple(shape)} needs {want} ranks; the "
                         f"running group has {n}")
    _ensure_group(device)
    return _mesh(tuple(shape), tuple(axes), device)


def make_serving_mesh(tp: int = 1, *, device="cuda"):
    """Mesh for one tensor-parallel serving replica: ("data", "model") =
    (n // tp, tp) over the running group's n ranks. The server shards
    attention heads, d_ff, the head's vocab and the paged pool's KV heads
    over "model" (``parallel.sharding``); "data" replicates. With no group
    running, ``tp`` = 1 opens a one-rank group (gloo on the CPU, NCCL on
    a card) and a larger ``tp`` needs its ranks spawned first (the CLI's
    ``--tp`` does)."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    n = _running_world(device)
    if n % tp != 0:
        raise ValueError(f"tp={tp} does not divide {n} visible devices")
    if not dist.is_initialized():
        if tp > 1:
            raise ValueError(f"tp={tp} needs a running process group of "
                             f"a multiple of {tp} ranks (spawn them, as "
                             f"launch.serve --tp does)")
        _ensure_group(device)
        n = 1
    return _mesh((n // tp, tp), ("data", "model"), device)

