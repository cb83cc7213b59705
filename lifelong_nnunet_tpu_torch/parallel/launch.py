"""Starting the ranks of ``-n_devices N``.

* :func:`spawn`: from a process that ``torchrun`` did not start, N rank
  processes (``torch.multiprocessing``, the ``spawn`` start method), one
  per entry of ``devices``; they meet at a ``FileStore`` under a folder
  the caller names (a fresh file per launch) and rank 0's return value
  comes back to the caller.
* :func:`join_torchrun`: under ``torchrun`` (``WORLD_SIZE`` set), join the
  group it was given: the counterpart of the JAX package's multi-host
  ``process_count() > 1``.

The backend (:func:`backend_for`): ``nccl`` when every rank has a GPU of
its own, ``gloo`` on the CPU and when ranks share a GPU (NCCL refuses two
ranks on one device).  The choice is printed by rank 0; nothing falls back
to another backend or device.
"""

from __future__ import annotations

import os
import pickle
import uuid

import torch
import torch.distributed as dist


def backend_for(devices) -> str:
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def _rank_entry(rank: int, fn, args: tuple, devices: list, store_path: str,
                result_path: str, threads: int | None):
    n = len(devices)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(n), GROUP_RANK="0")
    device = torch.device(devices[rank])
    if threads:
        torch.set_num_threads(threads)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend_for(devices)
    dist.init_process_group(backend, store=dist.FileStore(store_path, n), rank=rank,
                            world_size=n)
    try:
        if rank == 0:
            print(f"[launch] {n} ranks on {[str(d) for d in devices]}, backend {backend}",
                  flush=True)
        out = fn(str(device), *args)
        if rank == 0:
            with open(result_path + ".tmp", "wb") as f:
                pickle.dump(out, f)
            os.replace(result_path + ".tmp", result_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, args: tuple, devices: list, rdzv_dir: str, threads: int | None = None):
    """Run ``fn(device, *args)`` in ``len(devices)`` rank processes with an
    initialized default process group; returns rank 0's result.  ``fn``
    must be importable (module level); ``threads``: each rank's
    ``torch.set_num_threads`` (default: this process's threads shared
    out)."""
    n = len(devices)
    os.makedirs(rdzv_dir, exist_ok=True)
    base = os.path.join(rdzv_dir, f".rendezvous_{os.getpid()}_{uuid.uuid4().hex}")
    result = base + ".result"
    if threads is None:
        threads = max(1, torch.get_num_threads() // n)
    try:
        torch.multiprocessing.start_processes(
            _rank_entry, args=(fn, tuple(args), [str(d) for d in devices], base, result,
                               threads),
            nprocs=n, join=True, start_method="spawn")
        with open(result, "rb") as f:
            return pickle.load(f)
    finally:
        for path in (base, result):
            if os.path.exists(path):
                os.remove(path)


def join_torchrun(device_type: str) -> torch.device:
    """Join the process group ``torchrun`` set up (``env://``); returns this
    rank's device (``cuda:LOCAL_RANK``, or the CPU)."""
    local = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    if device_type == "cuda":
        if local_world > torch.cuda.device_count():
            raise RuntimeError(f"{local_world} ranks on this node but only "
                               f"{torch.cuda.device_count()} devices visible")
        devices = [f"cuda:{i}" for i in range(local_world)]
    else:
        devices = ["cpu"] * local_world
    device = torch.device(devices[local])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend_for(devices)
    dist.init_process_group(backend, init_method="env://")
    if dist.get_rank() == 0:
        print(f"[launch] joined torchrun: {dist.get_world_size()} ranks, backend {backend}",
              flush=True)
    return device


def in_torchrun() -> bool:
    return "WORLD_SIZE" in os.environ and "LOCAL_RANK" in os.environ \
        and not dist.is_initialized()
